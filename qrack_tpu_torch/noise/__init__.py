"""Monte-Carlo noisy trajectories (the JAX package's noise/).

Two halves of one contract:

* :mod:`channels` — single-qubit Kraus channel algebra, the
  :class:`NoiseModel` attachment policy, the counter-based
  per-trajectory rng, and the sequential :class:`QNoisy` oracle engine
  (factory terminal ``"noisy"``).
* :mod:`trajectories` — the batched engine: (circuit, NoiseModel, B)
  lowers into one op stream run over (B, 2, 2^n) planes with a leading
  trajectory axis, branch choices pre-sampled host-side into
  per-trajectory operands.

The load-bearing property: a trajectory is a pure function of
``(key, trajectory_id)`` — the batch engine and the sequential oracle
draw the same uniforms at the same channel-application counters, so any
single trajectory is reproducible in isolation (parity tests, checkpoint
resume), and the same numbers as the JAX package's.
"""

from .channels import (  # noqa: F401
    ChannelError,
    KrausChannel,
    NoiseModel,
    QNoisy,
    amplitude_damping,
    dephasing,
    depolarizing,
    kraus_channel,
    traj_uniform,
)
from .trajectories import (  # noqa: F401
    TrajectoryJob,
    TrajectoryResult,
    run_trajectories,
    traj_chunk,
)
