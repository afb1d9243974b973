"""The sub-sharded mesh routing path (counterpart of emqx_tpu/parallel)."""
