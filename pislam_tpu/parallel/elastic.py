"""Multi-host bootstrap + elastic checkpoint/resume for multi-process SLAM.

The reference is a single-core library with no failure story (SURVEY.md
section 5: no long-running service). Across processes (BASELINE.json
configs[4]) the equivalents are:

* process bootstrap: jax.distributed.initialize joins this process to the
  cluster's coordination service; XLA's own barrier/heartbeat layer then
  detects peer failure (a crashed host fails the collective, surfacing as a
  Python exception here rather than a hang).
* elasticity: SLAM state is a pytree (backend/keyframes.py), so recovery is
  checkpoint/restore (utils/checkpoint.py) plus re-initialisation at the new
  world size -- the CheckpointedRunner below packages the loop.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional

import jax


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> int:
    """Join the JAX distributed runtime (no-op on a single-process run).

    Arguments default from the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID); with neither arguments nor
    variables the run stays single-process. Returns the local process
    index.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    n = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "0") or 0)
    if coordinator and n > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=n,
            process_id=(process_id if process_id is not None
                        else int(os.environ.get("JAX_PROCESS_ID", "0"))),
        )
    return jax.process_index()


class CheckpointedRunner:
    """Periodic-checkpoint wrapper for a long-running SLAM loop.

    step_fn(state, item) -> state runs the (jitted) work; every
    `every` steps the state pytree is saved so a restarted worker -- or a
    re-shaped slice -- resumes from the last checkpoint instead of frame 0.
    """

    def __init__(self, step_fn: Callable[[Any, Any], Any], ckpt_dir: str,
                 every: int = 50):
        from ..utils import checkpoint as ckpt

        self._step = step_fn
        self._dir = ckpt_dir
        self._every = every
        self._ckpt = ckpt
        self.steps_done = 0

    def resume(self, init_state: Any) -> Any:
        """Restore the latest checkpoint if one exists, else init_state.

        The step counter lives INSIDE the checkpoint payload, so state and
        progress are restored atomically -- a crash can never resume with a
        newer state but an older counter (which would re-apply frames
        already folded into the state). In multi-process runs the counter is
        broadcast from process 0 so all hosts resume at the same step even
        on non-shared filesystems.
        """
        import jax.numpy as jnp

        path = os.path.join(self._dir, "state")
        if os.path.exists(path):
            payload = self._ckpt.restore(
                path, like={"state": init_state,
                            "steps_done": jnp.zeros((), jnp.int32)})
            self.steps_done = int(payload["steps_done"])
            state = payload["state"]
        else:
            state = init_state
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            self.steps_done = int(multihost_utils.broadcast_one_to_all(
                jnp.int32(self.steps_done)))
        return state

    def run(self, state: Any, items) -> Any:
        for i, item in enumerate(items):
            if i < self.steps_done:
                continue  # already covered by the restored checkpoint
            state = self._step(state, item)
            self.steps_done = i + 1
            if self.steps_done % self._every == 0:
                self._save(state)
        self._save(state)
        return state

    def _save(self, state):
        if jax.process_index() != 0:
            return
        import jax.numpy as jnp

        os.makedirs(self._dir, exist_ok=True)
        # single atomic payload: state + counter together (checkpoint.save
        # writes a temp dir and renames it into place)
        self._ckpt.save(os.path.join(self._dir, "state"),
                        {"state": state,
                         "steps_done": jnp.int32(self.steps_done)})
