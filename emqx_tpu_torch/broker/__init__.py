"""The port's broker (counterpart of emqx_tpu/broker/): sessions,
pubsub dispatch, the pipelined dispatch engine, the MQTT channel and
the asyncio TCP server (no WebSocket, QUIC or gateway listeners)."""
