"""The broker's publish path for the port: sessions, pubsub dispatch
and the pipelined dispatch engine (counterpart of emqx_tpu/broker/,
without the server, channel and transport layers)."""
