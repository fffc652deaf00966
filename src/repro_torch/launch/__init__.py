"""Entry points and the layout of a run: the training CLI (``train``), the
decode driver (``serve``), the meshes and ranks of ``torch.distributed``
(``mesh``) and the layout rules of parameters, batches and caches over
them (``sharding``)."""
from .mesh import (
    client_axes,
    make_debug_mesh,
    make_production_mesh,
    num_clients,
    run_on_ranks,
)
from .sharding import PartitionSpec, to_placements
