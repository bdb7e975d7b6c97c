"""Multi-host runtime: jax.distributed bring-up + host-local IQ ingest.

The reference distributes across PROCESSES with shell pipes and byte
protocols (examples/README.md:22-46, SURVEY.md §5.8); this framework
distributes across GPU HOSTS with the jax.distributed runtime. Each host
ingests the IQ for its own ensembles (the network between hosts carries
only the host->device ingest fan-out) and the ('ens','time','sub') mesh
spans every card, with the halo/collective traffic riding NVLink inside a
host (NCCL) within multichip_receiver_step.

Single-host use needs none of this — jax.devices() already sees the local
cards. Across hosts, call `initialize()` on every host before any JAX
use, then build the global mesh and wrap each host's IQ block with
`host_local_iq_to_global`.
"""


import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import make_receiver_mesh

_initialized = False


def _runtime_already_up() -> bool:
    """Whether jax.distributed is already initialized — WITHOUT touching
    any API (jax.process_count() etc.) that would itself instantiate the
    XLA backend: jax.distributed.initialize() hard-fails after any such
    call, so the guard must stay backend-free."""
    try:
        from jax._src import distributed as _dist
        gs = _dist.global_state
        return gs.client is not None or gs.coordinator_address is not None
    except Exception:
        return False


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, auto=False, **kw):
    """Bring up the jax.distributed runtime. Idempotent: a second call
    (same or different args) is a no-op returning False, as is a plain
    single-host process. Pass auto=True only where a cluster manager
    tells jax.distributed about the cluster; otherwise set the arguments
    explicitly (coordinator 'host0:port', num_processes, process_id).
    Must be the first JAX call in the process (jax.distributed's own
    contract)."""
    global _initialized
    if _initialized or _runtime_already_up():
        return False                         # already initialized
    if coordinator_address is None and num_processes is None and not auto:
        return False                         # plain single-host process
    if num_processes == 1 and coordinator_address is None:
        return False                         # explicit single host
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kw)
    _initialized = True
    return True


def global_receiver_mesh(axis_sizes=None) -> Mesh:
    """('ens','time','sub') mesh over every device in the slice (all
    hosts). Axis policy is make_receiver_mesh's; 'ens' absorbs the host
    dimension, so each host's local ensembles shard onto its own cards
    and FIC/MSC collectives stay intra-host where possible."""
    return make_receiver_mesh(len(jax.devices()), axis_sizes=axis_sizes)


def host_local_iq_to_global(mesh: Mesh, iq_local: np.ndarray,
                            spec: P = P("ens", "time")):
    """Assemble each host's local IQ block (B_local, T[, 2]) into one
    global sharded array without any cross-host data movement: host h's
    rows land on host h's devices (addressable shards only).

    The global batch is B_local * process_count; callers index their
    ensembles as [process_index * B_local, ...)."""
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, iq_local)
