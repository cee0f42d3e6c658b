from speech_recognition_tpu_torch.parallel.mesh import (
    bank_shard,
    batch_shard,
    init_distributed,
    make_mesh,
)
from speech_recognition_tpu_torch.parallel.trainer import (
    make_sharded_classifier,
    make_sharded_embedded_step,
    shard_embedded_inputs,
)
