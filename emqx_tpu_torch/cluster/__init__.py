"""Cluster layer of the port. Ported so far: the term codec (wire.py,
the port's own copy of emqx_tpu/cluster/wire.py), with which the
persistent retainer encodes its KV records, and the eviction agent
(rebalance.py), which the disconnect/takeover chaos scenario drives.
The RPC plane, membership and the replicated route table are not
ported yet (ROADMAP Queue 1 item 8)."""
