from tpusparse_torch.testing.generators import (  # noqa: F401
    block_pruned_matrix,
    mesh_csr,
    random_sparse_batch,
    random_sparse_csr,
    random_sparse_matrix,
    random_sparse_vector,
    stencil_csr,
)
from tpusparse_torch.testing.reference import sgemm_cpu, sgemv_cpu  # noqa: F401
from tpusparse_torch.testing.tester import (  # noqa: F401
    CompareReport,
    KernelEntry,
    SpmvTester,
)
