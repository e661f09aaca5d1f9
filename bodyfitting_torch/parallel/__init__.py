"""Multi-device fits over ``torch.distributed``: frame and view data
parallelism (:mod:`.sharding`) and the vertex-sharded body model
(:mod:`.tensor`); counterpart of ``bodyfitting_tpu/parallel``.  The
collectives they run are :mod:`bodyfitting_torch.ops.comm`'s.
"""

from bodyfitting_torch.parallel.sharding import (  # noqa: F401
    fit_sequence_sharded,
    init_world,
    make_mesh,
)
from bodyfitting_torch.parallel.tensor import (  # noqa: F401
    make_tp_mesh,
    replicate_params,
    shard_model_vertices,
)
