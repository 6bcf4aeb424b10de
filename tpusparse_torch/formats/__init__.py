from tpusparse_torch.formats.csr import CsrMatrix  # noqa: F401
from tpusparse_torch.formats.sell import SellMatrix  # noqa: F401
from tpusparse_torch.formats.awsp import AwspMatrix  # noqa: F401
from tpusparse_torch.formats.rsell import RsellMatrix  # noqa: F401
from tpusparse_torch.formats.bsr import BsrMatrix  # noqa: F401
from tpusparse_torch.formats.tcsr import TcsrMatrix  # noqa: F401
from tpusparse_torch.formats.dia import DiaMatrix  # noqa: F401
from tpusparse_torch.formats.ell import EllMatrix  # noqa: F401
from tpusparse_torch.formats.bell import BellMatrix  # noqa: F401
from tpusparse_torch.formats.binned import BinnedSellMatrix  # noqa: F401
from tpusparse_torch.kernels.asp_spmv import AspMatrix  # noqa: F401
from tpusparse_torch.formats.auto import (  # noqa: F401
    auto_format,
    matrix_stats,
    matrix_stats_csr,
    route,
)
from tpusparse_torch.formats.convert import (  # noqa: F401
    from_reference_arrays,
    load_trainable_arrays,
)
