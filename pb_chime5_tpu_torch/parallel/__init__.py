"""Distribution: host-level work sharding and device-level mesh sharding
(the port of ``pb_chime5_tpu.parallel``).

* host level (across processes): ``scheduler`` — length-balanced or
  strided static shards, and a file-lock work queue; ``distributed`` —
  the gloo process group of ``torch.distributed``;
* device level (across devices of one process): ``mesh`` — a (data,
  freq) grid of devices, batched enhancement with data parallelism over
  utterances and frequency parallelism within one; ``batch_driver`` —
  the collation of a session's utterances into such batches.
"""

from pb_chime5_tpu_torch.parallel.scheduler import (
    serial_shard,
    strided_shard,
    length_balanced_shard,
    FileQueueScheduler,
    process_info,
)
from pb_chime5_tpu_torch.parallel.mesh import (
    make_mesh,
    batched_gss_enhance,
    sharded_gss_enhance,
)
from pb_chime5_tpu_torch.parallel.batch_driver import (
    BatchDispatcher,
    DispatchedBatch,
)
from pb_chime5_tpu_torch.parallel.distributed import (
    maybe_initialize,
    is_master,
    barrier,
)
