from tpusparse_torch.testing.generators import (  # noqa: F401
    banded_defects_csr,
    block_pruned_matrix,
    mesh_csr,
    nm_pruned_matrix,
    random_sparse_batch,
    random_sparse_csr,
    random_sparse_matrix,
    random_sparse_vector,
    rmat_csr,
    stencil_csr,
)
from tpusparse_torch.testing.reference import (  # noqa: F401
    csr_spmm_cpu,
    sgemm_cpu,
    sgemv_cpu,
)
from tpusparse_torch.testing.tester import (  # noqa: F401
    CompareReport,
    KernelEntry,
    SpmvTester,
)
