"""Cluster layer of the port. Only the term codec (wire.py, the port's
own copy of emqx_tpu/cluster/wire.py) is ported so far: the persistent
retainer encodes its KV records with it. The RPC plane, membership and
the replicated route table are not ported yet."""
