"""The port's fault tolerance on the CPU: ``tests/test_fault_tolerance.py``
on the port (an injected failure and the supervisor's restart continue
bit for bit from the checkpoint; the straggler watchdog and the
heartbeat), the same through ``launch/train.py`` with
``--simulate-failure-at``, and the copied module against the reference's.
"""
import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.train import fault_tolerance as jft  # noqa: E402
from repro_torch.configs.base import get_config, reduced_config  # noqa: E402
from repro_torch.data.tokens import SyntheticTokens  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.train import fault_tolerance as ft  # noqa: E402
from repro_torch.train.checkpoint import (  # noqa: E402
    latest_step, restore_checkpoint, save_checkpoint)
from repro_torch.train.fault_tolerance import (  # noqa: E402
    FailureInjector, Heartbeat, SimulatedFailure, StragglerWatchdog,
    run_supervised)
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    init_train_state, make_train_step)
from repro_torch.utils.tree import tree_leaves  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    these training loops would otherwise take every core from the
    others' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup():
    cfg = reduced_config(get_config("smollm_360m"))
    model = build_model(cfg, device="cpu")
    data = SyntheticTokens(cfg.vocab_size, 16, 4, seed=0)
    step = make_train_step(model, AdamWConfig(peak_lr=1e-3))
    return model, data, step


def _run(model, data, step, root, n_steps, injector=None, ckpt_every=3):
    """Checkpointed loop resuming from the last committed step."""
    state = init_train_state(model,
                             generator=torch.Generator().manual_seed(0))
    start = 0
    if latest_step(root) is not None:
        state, start = restore_checkpoint(root, state)
    losses = {}
    for i in range(start, n_steps):
        if injector:
            injector.check(i)
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
        state, metrics = step(state, batch)
        losses[i] = float(metrics["loss"])
        if (i + 1) % ckpt_every == 0:
            save_checkpoint(root, i + 1, state)
    return state, losses


def test_restart_is_bit_exact(tmp_path):
    model, data, step = _setup()
    # uninterrupted run
    s_ref, _ = _run(model, data, step, str(tmp_path / "a"), 9)
    final_ref = [t.clone() for t in tree_leaves(s_ref.params)]
    # interrupted at step 5, supervisor restarts from ckpt at step 3
    inj = FailureInjector(fail_at_steps=[5])
    root = str(tmp_path / "b")

    def loop(_resume):
        _, losses = _run(model, data, step, root, 9, injector=inj)
        return {"steps": 9}

    report = run_supervised(loop, max_restarts=2)
    assert report.restarts == 1
    s_rec, _ = _run(model, data, step, root, 9)  # no-op rerun from ckpt
    # compare final params bit-exactly
    for a, b in zip(final_ref, tree_leaves(s_rec.params)):
        assert torch.equal(a, b)


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    calls = []

    def loop(_):
        calls.append(1)
        raise SimulatedFailure("permanently broken")

    with pytest.raises(SimulatedFailure):
        run_supervised(loop, max_restarts=2)
    assert len(calls) == 3            # initial + 2 restarts


def test_straggler_watchdog():
    wd = StragglerWatchdog(factor=2.0, warmup=2)
    for i in range(10):
        assert not wd.record(i, 1.0)
    assert wd.record(10, 5.0)           # 5x EWMA -> flagged
    assert not wd.record(11, 1.1)       # back to normal
    assert len(wd.events) == 1
    assert wd.events[0]["step"] == 10


def test_heartbeat(tmp_path):
    hb = Heartbeat(str(tmp_path / "hb.json"), interval_s=0.0)
    assert hb.age() is None
    hb.beat(5, force=True)
    age = hb.age()
    assert age is not None and age < 5.0


def _cli(root, *extra):
    return train_cli.main(
        ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
         "--steps", "8", "--batch", "4", "--seq", "16", "--log-every", "1",
         "--ckpt-every", "3", "--ckpt-dir", str(root), *extra])


def _files(root, step):
    d = os.path.join(root, f"step_{step:08d}")
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.endswith(".npy")}


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_cli_restart_is_bit_exact(tmp_path, capsys, compression):
    """``launch/train.py`` failing at step 5 restarts from its step-3
    checkpoint and ends on the same state files, byte for byte, as an
    uninterrupted run; the loss falls."""
    a, b = tmp_path / "a", tmp_path / "b"
    comp = ["--compression", compression]
    _cli(a, *comp)
    out_a = capsys.readouterr().out
    report = _cli(b, *comp, "--simulate-failure-at", "5")
    out_b = capsys.readouterr().out
    assert report.restarts == 1
    assert "[restore] resumed from step 3" in out_b
    assert "restarts=1" in out_b and "restarts=0" in out_a
    fa, fb = _files(str(a), 8), _files(str(b), 8)
    assert fa.keys() == fb.keys() and len(fa) > 0
    assert all(fa[k] == fb[k] for k in fa)
    losses = [float(line.split()[3]) for line in out_a.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 8 and losses[-1] < losses[0]


def test_module_is_the_reference_copy():
    """Standard library only, and the same code as the reference's (the
    module docstring and one docstring's wording aside)."""
    for name in ("FailureInjector", "Heartbeat", "SupervisorReport",
                 "run_supervised", "SimulatedFailure"):
        assert inspect.getsource(getattr(ft, name)) == \
            inspect.getsource(getattr(jft, name))
    src = inspect.getsource(ft)
    assert "import torch" not in src and "import jax" not in src
    assert np.isclose(StragglerWatchdog().factor, jft.StragglerWatchdog().factor)
