"""Multi-rank SpMV/SpMM over ``torch.distributed``: the counterpart of
``tpusparse/parallel``. One process a rank; ``initialize()`` first, then a
mesh (``make_mesh``, ``default_mesh``, ``global_mesh``) and the sharded
maps (dense ``spmv_sharded`` here, the sparse formats' in
``parallel.sparse``)."""

from tpusparse_torch.parallel.mesh import make_mesh, default_mesh  # noqa: F401
from tpusparse_torch.parallel.partition import (  # noqa: F401
    spmv_sharded,
    Partition,
)
from tpusparse_torch.parallel.launch import (  # noqa: F401
    initialize,
    global_mesh,
    process_slab,
    host_local_matrix,
)
from tpusparse_torch.parallel.sparse import (  # noqa: F401
    awsp_shard_slabs,
    awsp_spmm_sharded,
    binned_spmm_sharded,
    bsr_shard_pack,
    bsr_spmm_sharded,
    dia_spmm_sharded,
    rsell_spmm_sharded,
    sell_spmm_sharded,
    tcsr_shard_pack,
    tcsr_spmm_sharded,
)
