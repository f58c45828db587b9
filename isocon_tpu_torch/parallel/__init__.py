"""Multi-device and multi-process sharding of the engine's kernels
(counterpart of ``isocon_tpu/parallel``)."""
from .mesh import make_mesh
from .sharding import Sharder
