"""emqx_tpu_torch — the PyTorch/CUDA port of emqx_tpu's MQTT broker
(batched wildcard routing, the publish fanout and the SUBSCRIBE-side
retained reads), for one NVIDIA Hopper card.

The JAX package `emqx_tpu` stays beside it as the reference: every
kernel here is held equal to its JAX counterpart on the same seeded
inputs. This package imports nothing from `emqx_tpu` and never imports
`jax`; it keeps its own copy of every host module it needs.

Entry points (`python -m emqx_tpu_torch.broker.server`,
`broker.server.Server`, `broker.pubsub.Broker`,
`models.retainer.Retainer.enable_device`, `models.router.Router`,
`models.router.DeviceTable`) run on the CUDA device unless the caller
passes `device="cpu"`; without a CUDA device they raise rather than
fall back.
"""
