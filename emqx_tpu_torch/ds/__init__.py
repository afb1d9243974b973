"""The durable tier of the port (the port's own copy of emqx_tpu/ds/,
without the replication plane): the WAL engine (kvstore.py over
native/kvlog.cc), the learned topic structure (lts.py), shards and
generations (storage.py), the write buffer (buffer.py), the DS API
(api.py), durable sessions (session_ds.py), durable shared queues
(shared_queue.py), the disk seam (diskio.py) and the `emqx_ds_*`
ledger (metrics.py). Every module is host code: the tier reaches the
card only through the broker's publish path and the retained index."""

from .api import Db, close_db, kill_db, open_db
from .kvstore import NativeKv, PyKv, open_kv
from .lts import LtsTrie, varying_match
from .storage import (
    DsIterator,
    StorageLayer,
    Stream,
    deserialize_message,
    serialize_message,
)
