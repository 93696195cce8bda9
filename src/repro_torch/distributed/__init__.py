"""repro_torch.distributed — the sharding names the training step reads.

Only the no-mesh case is here (one device): ``BATCH_AXES`` and
``constrain``, which is then the identity.  Meshes, parameter shardings,
gradient compression and pipeline stages over ``torch.distributed`` are
ROADMAP item A13.
"""
from repro_torch.distributed.sharding import BATCH_AXES, constrain  # noqa: F401
