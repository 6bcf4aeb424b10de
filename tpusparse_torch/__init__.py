"""tpusparse_torch: the PyTorch/CUDA port of tpusparse for NVIDIA Hopper.

``Y = X @ A`` SpMV/SpMM over SELL, AWSP, RSELL, ASP, BSR, TCSR, DIA, ELL,
BELL and binned SELL packs, picked by ``auto_format`` or by hand, and
sparse-weight training (``linear_map``, ``trainable_linear``,
``nn.SparseLinear``, and over a device mesh ``linear_map_sharded`` and
``trainable_linear_sharded``) with the pruning and graph on-ramps, and the solver
path (``solve``, ``eig``, ``amg``, ``reorder``, pack persistence in
``formats.io`` and the native host converters in ``native``), with kernels
written by hand for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first
use; the benches (``bench``), the command line (``python -m
tpusparse_torch``) and the examples (``examples``) drive it. Entry
points run on the GPU unless the caller passes ``device="cpu"``, which runs
each kernel's plain PyTorch version. The package imports torch and numpy
only; the JAX package ``tpusparse`` is its reference and is never imported.
"""

from tpusparse_torch.autodiff import (  # noqa: F401
    linear_map,
    linear_map_sharded,
    trainable_linear,
    trainable_linear_sharded,
)
from tpusparse_torch.config import SpmvConfig  # noqa: F401
from tpusparse_torch.formats import (  # noqa: F401
    AspMatrix,
    AwspMatrix,
    BellMatrix,
    BinnedSellMatrix,
    BsrMatrix,
    CsrMatrix,
    DiaMatrix,
    EllMatrix,
    RsellMatrix,
    SellMatrix,
    TcsrMatrix,
    auto_format,
    from_reference_arrays,
    load_trainable_arrays,
    matrix_stats,
    matrix_stats_csr,
)
from tpusparse_torch.graph import normalized_adjacency  # noqa: F401
from tpusparse_torch.ops import spmm, spmv  # noqa: F401
from tpusparse_torch.prune import block_prune, magnitude_prune, nm_prune  # noqa: F401
from tpusparse_torch.testing import KernelEntry, SpmvTester  # noqa: F401
