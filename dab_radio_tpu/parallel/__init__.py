"""Mesh sharding for multi-card scale-out.

The reference's parallelism is threads inside one process (SURVEY.md §2.6);
this design scales along two axes instead: the *ensemble* axis (many
independent 2.048 MSPS streams, embarrassingly parallel -> data parallel)
and the *time-block* axis (one stream's frames split across cards with a
one-window halo exchanged over NVLink via ppermute -> sequence parallel), plus
the *subchannel* axis for the MSC Viterbi stage (expert-parallel-shaped).
"""

from .mesh import (
    make_receiver_mesh,
    shard_demod_batch,
    make_timesharded_demod,
    make_coldstart_timesharded_demod,
    multichip_receiver_step,
)
from .distributed import (
    initialize,
    global_receiver_mesh,
    host_local_iq_to_global,
)
