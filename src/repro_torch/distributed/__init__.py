"""repro_torch.distributed — training over a ``DeviceMesh``: the sharding
rules and ``constrain`` (``sharding``), int8 error-feedback gradient
compression over 'pod' (``compress``) and the GPipe pipeline
(``pipeline``), on ``torch.distributed``."""
from repro_torch.distributed.sharding import (  # noqa: F401
    BATCH_AXES,
    AbstractMesh,
    NamedSharding,
    constrain,
    decode_state_shardings,
    input_shardings,
    param_shardings,
    put,
    replicated,
    use_mesh,
)
