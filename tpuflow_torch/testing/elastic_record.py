"""A per-member record of an elastic gang's ``train_gpt`` run, for the
checks of a shrink or grow: which steps each generation ran and their
losses, and whether every restore across a world change gave back the
committed step bit for bit.

``record_elastic(path, ckpt_dir)`` patches this process's ``train_gpt``
(call it in the gang member, before the step body trains) to append one
JSON line to ``path`` for each event, every line holding the member's
generation ``gen``, its world ``world``, the wall time ``t`` and the keys
of ``extra()``:

- ``{"start": true}``: the recorder was installed;
- ``{"step", "loss"}``: every optimizer step run (the steps a later
  generation replays too);
- ``{"validation"}``: every validation pass's loss;
- ``{"restore"}``: the checkpoint manager's record of each restore;
- ``{"restored", "regions"}``: each state restore from ``ckpt_dir``,
  ``regions`` holding each leaf's ``[path, start, shape, crc32 restored,
  crc32 committed]``: the region this process restored, and the same
  region of the committed step read whole at one process right after
  (before retention may delete it);
- ``{"reformed", "reform_s"}``: each re-form's generation and the
  seconds of its teardown and rendezvous;
- ``{"result_steps", "epochs"}``: the call's result.
"""

from __future__ import annotations

import json
import os
import time
import zlib

__all__ = ["record_elastic"]


def _crc(t) -> int:
    import torch

    return zlib.crc32(torch.as_tensor(t).detach().cpu().contiguous()
                      .reshape(-1).view(torch.uint8).numpy())


def record_elastic(path: str, ckpt_dir: str, extra=None) -> None:
    """Patch this process's ``train_gpt`` to record into ``path`` (see the
    module docstring); ``extra``: a function whose dict joins each
    line."""
    from tpuflow_torch import dist
    from tpuflow_torch.ckpt import CheckpointManager, raw
    from tpuflow_torch.ckpt.tree import checkpoint_tree
    from tpuflow_torch.dist import membership
    from tpuflow_torch.train import gpt

    def line(**kw):
        with open(path, "a") as f:
            f.write(json.dumps(
                {"gen": membership.current_generation(),
                 "world": dist.process_count(), "t": time.time(),
                 **(extra() if extra is not None else {}), **kw},
                default=float) + "\n")

    real_make = gpt.make_train_step

    def make(*a, **kw):
        step = real_make(*a, **kw)

        def run(*args):
            state, metrics = step(*args)
            line(step=state.step, loss=float(metrics["loss"]))
            return state, metrics

        return run

    real_val = gpt.run_validation

    def validation(*a, **kw):
        loss = real_val(*a, **kw)
        line(validation=float(loss))
        return loss

    real_load = gpt.load_checkpoint_tree

    def load(state, restored):
        tmpl = checkpoint_tree(state, scan_layers=state.model.config
                               .scan_layers, abstract=True)
        got = list(zip(raw.flatten(tmpl), raw.flatten(restored)))
        real_load(state, restored)
        whole = dict(("/".join(p), t) for p, t in raw.flatten(
            raw.restore_raw(os.path.join(ckpt_dir, f"step_{state.step}",
                                         "state"))))
        regions = []
        for (p, t), (_, leaf) in got:
            shape = list(leaf.shape)
            start = t.start if isinstance(t, raw.Piece) else [0] * len(shape)
            cut = tuple(slice(a, a + n) for a, n in zip(start, shape))
            regions.append(["/".join(p), start, shape, _crc(leaf),
                            _crc(whole["/".join(p)][cut])])
        line(restored=state.step, regions=regions)

    real_restore = CheckpointManager.restore

    def restore(self, *a, **kw):
        out = real_restore(self, *a, **kw)
        line(restore=self.restores[-1])
        return out

    real_reform = membership.quiesce_and_reform

    def reform(plan):
        t0 = time.monotonic()
        real_reform(plan)
        line(reformed=plan.generation, reform_s=time.monotonic() - t0)

    real_train = gpt.train_gpt

    def train(*a, **kw):
        res = real_train(*a, **kw)
        line(result_steps=len(res.step_losses),
             epochs=[m["epoch"] for m in res.metrics_history])
        return res

    gpt.make_train_step = make
    gpt.run_validation = validation
    gpt.load_checkpoint_tree = load
    CheckpointManager.restore = restore
    membership.quiesce_and_reform = reform
    gpt.train_gpt = train
    line(start=True)
