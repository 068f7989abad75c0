"""The port's checkpoints (`repro_torch.train.checkpoint`), train loop
(`repro_torch.train.fault_tolerance`), `HostPrefetcher` and the train
CLI's ``--ckpt-dir`` against the JAX package's, on the CPU.

Bars: checkpoint digests and bytes exactly the JAX package's (each package
reads the other's checkpoint of a nested dict bitwise); a scripted loss
sequence drives both packages' loops to the same events (log lines, lr
scales, data indices, rollbacks, saves); a resumed run's losses and
weights bitwise the uninterrupted run's.
"""

import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.robust import abft as jabft  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import fault_tolerance as jft  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import synthetic as tsynthetic  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.train import build_trainer  # noqa: E402
from repro_torch.robust import abft  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import fault_tolerance as tft  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_counters():
    abft.reset_runtime_sdc()
    jabft.reset_runtime_sdc()
    yield
    abft.reset_runtime_sdc()
    jabft.reset_runtime_sdc()


def _values():
    rng = np.random.default_rng(0)
    return {
        "a": rng.standard_normal((2, 3)).astype(np.float32),
        "nested": {"b": rng.standard_normal(4).astype(ml_dtypes.bfloat16), "step": np.int32(7)},
        "z": np.arange(5, dtype=np.int32),
    }


def _torch_tree(vals):
    return {"a": torch.from_numpy(vals["a"]),
            "nested": {"b": torch.from_numpy(vals["nested"]["b"].view(np.int16)).view(torch.bfloat16),
                       "step": torch.tensor(7, dtype=torch.int32)},
            "z": torch.from_numpy(vals["z"])}


def _jax_tree(vals):
    return {"a": jnp.asarray(vals["a"]), "nested": {"b": jnp.asarray(vals["nested"]["b"]),
                                                     "step": jnp.asarray(7, jnp.int32)},
            "z": jnp.asarray(vals["z"])}


def _bits(x):
    """The stored bytes of a leaf as a flat uint8 array (bf16 by its bits)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).reshape(-1)


def _leaf(tree, name):
    for key in name.split("__"):
        tree = tree[key]
    return tree


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_digest_is_jaxs(dtype):
    rng = np.random.default_rng(1)
    arr = rng.standard_normal((5, 7)).astype(np.float32)
    jarr = jnp.asarray(arr).astype(dtype)
    tarr = torch.from_numpy(arr).to(getattr(torch, dtype)) if dtype != "int32" else torch.from_numpy(
        np.array(jarr))
    stored_t, logical_t = tckpt._to_host(tarr)
    stored_j = np.asarray(jarr)
    if str(stored_j.dtype) in jckpt._VIEW_DTYPES:
        stored_j = stored_j.view(jckpt._VIEW_DTYPES[str(stored_j.dtype)])
    assert logical_t == dtype and stored_t.dtype == stored_j.dtype
    assert tckpt._digest(stored_t) == jckpt._digest(stored_j)


def test_each_package_reads_the_others_checkpoint_bitwise(tmp_path):
    vals = _values()
    tckpt.save(str(tmp_path / "port"), 3, _torch_tree(vals), extra={"note": 1})
    jckpt.save(str(tmp_path / "jax"), 3, _jax_tree(vals), extra={"note": 1})
    tman = json.loads((tmp_path / "port" / "step_00000003" / "manifest.json").read_text())
    jman = json.loads((tmp_path / "jax" / "step_00000003" / "manifest.json").read_text())
    assert tman == jman  # names, order, shapes, dtypes, digests, extra
    j_of_t, _ = jckpt.restore(str(tmp_path / "port"), 3)
    t_of_j, manifest = tckpt.restore(str(tmp_path / "jax"), 3)
    assert manifest["extra"] == {"note": 1}
    for leaf in jman["leaves"]:
        name = leaf["name"]
        want = _bits(_leaf(_jax_tree(vals), name))
        np.testing.assert_array_equal(_bits(_leaf(j_of_t, name)), want)
        np.testing.assert_array_equal(_bits(_leaf(t_of_j, name)), want)
    assert _leaf(t_of_j, "nested__b").dtype == torch.bfloat16


def _corrupt_one_leaf(step_dir):
    npy = sorted(step_dir.glob("*.npy"))[0]
    blob = bytearray(npy.read_bytes())
    blob[-1] ^= 0xFF  # flip bits in the data section, not the header
    npy.write_bytes(bytes(blob))


def test_checkpoint_digest_catches_bit_rot(tmp_path):
    tree = {"w": torch.arange(16, dtype=torch.float32), "b": torch.ones(4, dtype=torch.bfloat16)}
    tckpt.save(str(tmp_path), 7, tree)
    got, _ = tckpt.restore(str(tmp_path), 7)
    assert torch.equal(got["w"], tree["w"])
    _corrupt_one_leaf(tmp_path / "step_00000007")
    with pytest.raises(tckpt.CheckpointIntegrityError, match="corrupt"):
        tckpt.restore(str(tmp_path), 7)


def test_checkpoint_legacy_manifest_loads_unverified(tmp_path):
    tckpt.save(str(tmp_path), 1, {"w": torch.arange(8, dtype=torch.float32)})
    mpath = tmp_path / "step_00000001" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    for leaf in manifest["leaves"]:
        leaf.pop("digest", None)
    mpath.write_text(json.dumps(manifest))
    _corrupt_one_leaf(tmp_path / "step_00000001")
    got, _ = tckpt.restore(str(tmp_path), 1)  # no digest: loads, unverified
    assert got["w"].shape == (8,)


def test_save_async_keeps_the_state_from_before_an_in_place_step(tmp_path):
    """The host copy is taken before `save_async` returns: a step that then
    writes the tensors in place (as the port's optimizer does) does not
    reach the checkpoint."""
    w = torch.arange(1 << 16, dtype=torch.float32)
    want = w.clone()
    t = tckpt.save_async(str(tmp_path), 1, {"w": w})
    w.mul_(-3.0).add_(1.0)  # the next step, in place
    t.join(timeout=60)
    assert not t.is_alive()
    got, _ = tckpt.restore(str(tmp_path), 1)
    assert torch.equal(got["w"], want)


def test_restore_into_a_target_writes_the_live_tensors_in_place(tmp_path):
    vals = _values()
    tckpt.save(str(tmp_path), 2, _torch_tree(vals))
    target = {"a": torch.zeros(2, 3), "nested": {"b": torch.zeros(4, dtype=torch.bfloat16),
                                                  "step": torch.zeros((), dtype=torch.int32)},
              "z": torch.zeros(5, dtype=torch.int32)}
    ptrs = [target["a"].data_ptr(), target["nested"]["b"].data_ptr()]
    got, _ = tckpt.restore(str(tmp_path), 2, target=target)
    assert got["a"] is target["a"] and [got["a"].data_ptr(), got["nested"]["b"].data_ptr()] == ptrs
    for name in ("a", "nested__b", "nested__step", "z"):
        np.testing.assert_array_equal(_bits(_leaf(got, name)), _bits(_leaf(_torch_tree(vals), name)))
    with pytest.raises(ValueError, match="does not fit"):
        tckpt.restore(str(tmp_path), 2, target=dict(target, a=torch.zeros(3, 2)))


def test_latest_step_ignores_torn_writes_and_cleanup_keeps_the_newest(tmp_path):
    tree = {"w": torch.ones(3)}
    for step in (10, 20, 30):
        tckpt.save(str(tmp_path), step, tree)
    (tmp_path / "step_00000040").mkdir()  # a torn write: no COMMITTED
    assert tckpt.latest_step(str(tmp_path)) == jckpt.latest_step(str(tmp_path)) == 30
    tckpt.cleanup(str(tmp_path), keep=2)  # by name, committed or not, as the JAX package's
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000030", "step_00000040"]


# ---------------------------------------------------------------------------
# the synthetic data stream
# ---------------------------------------------------------------------------


def test_host_prefetcher_orders_steps_as_jaxs():
    cfg = dict(vocab=31, seq_len=4, global_batch=2, seed=0)
    got, want = [], []
    for mod, out in ((tsynthetic, got), (jsynthetic, want)):
        src = mod.SyntheticLM(mod.SyntheticLMConfig(**cfg))
        pf = mod.HostPrefetcher(src, start_step=3, depth=2)
        try:
            out.extend(pf.next() for _ in range(3))
        finally:
            pf.close()
    assert [s for s, _ in got] == [s for s, _ in want] == [3, 4, 5]
    for (_, b), (_, c) in zip(got, want):
        np.testing.assert_array_equal(b["tokens"], c["tokens"])


# ---------------------------------------------------------------------------
# the train loop: scripted sequences through both packages
# ---------------------------------------------------------------------------


class _StubStep:
    """A host train_step of either package: finite batches bump w by 1,
    poisoned ones leave it (the guard's skip), a batch marked "sdc" counts
    a detection in the step and lands a corrupt update; every lr_scale and
    data index is recorded."""

    def __init__(self, jax_side):
        self.jax_side = jax_side
        self.lr_seen = []

    def __call__(self, params, opt_state, batch, lr_scale=None):
        self.lr_seen.append(lr_scale)
        loss = float(batch["loss"])
        bump = 1.0 if math.isfinite(loss) else 0.0
        if batch.get("sdc"):
            bump = 1000.0
            if self.jax_side:
                jabft._record_runtime_sdc("gemm", True, 1.0, 0.0)
            else:
                with abft.abft_mode("detect"), abft.step_scope():
                    assert abft.record_injected("gemm")
        return {"w": params["w"] + bump}, opt_state, {"loss": loss}


def _run_both(tmp_path, batch_of, phases, policy_kw, *, loop_kw=None, tail=None):
    """Run ``phases`` ((num_steps, resume) each) of a TrainLoop in each
    package from the same start; returns {package: (events, final w)}."""
    out = {}
    for name, ft, ckpt_mod, zeros in (("jax", jft, jckpt, lambda: (jnp.zeros((), jnp.float32),
                                                                   jnp.zeros((), jnp.int32))),
                                      ("port", tft, tckpt, lambda: (torch.zeros(()),
                                                                    torch.zeros((), dtype=torch.int32)))):
        stub, seen, logs, metrics = _StubStep(name == "jax"), [], [], []

        def batch_fn(i):
            seen.append(i)
            return batch_of(i)

        ckpt = ckpt_mod.CheckpointManager(str(tmp_path / name), interval=1000, keep=3)
        loop = ft.TrainLoop(stub, batch_fn, ckpt, on_metrics=metrics.append,
                            **{("nonfinite_policy" if "skip_steps" in policy_kw else "corruption_policy"):
                               (ft.CorruptionPolicy(**policy_kw))}, **(loop_kw or {}))
        w, opt = zeros()
        params, events = {"w": w}, {}
        for i, (steps, resume) in enumerate(phases):
            try:
                params, opt, history = loop.run(params, opt, num_steps=steps, resume=resume, log_every=0,
                                                logger=logs.append)
                events[f"history{i}"] = [(s, float(x)) for s, x in history]
            except RuntimeError as exc:
                events[f"raised{i}"] = str(exc)
        events.update(logs=logs, lr_seen=stub.lr_seen, data=seen, on_metrics=metrics)
        out[name] = (events, float(params["w"]))
    return out


def _comparable(x):
    """Events with NaN losses made comparable, without wall times."""
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, dict):  # a step's wall time is no event
        return {k: _comparable(v) for k, v in x.items() if k != "dt_s"}
    if isinstance(x, (list, tuple)):
        return type(x)(_comparable(v) for v in x)
    return x


def _same_events(out):
    (jev, jw), (tev, tw) = out["jax"], out["port"]
    assert set(tev) == set(jev)
    for key in jev:
        assert _comparable(tev[key]) == _comparable(jev[key]), key
    assert tw == jw


def test_trainloop_streak_policy_matches_jax(tmp_path):
    """Three healthy steps; a resume into a poisoned window: skips, an lr
    backoff, two rollbacks with the data stream skipped ahead, recovery."""
    poisoned = set(range(3, 10))
    out = _run_both(tmp_path, lambda i: {"loss": float("nan") if i in poisoned else 1.0}, [(3, False), (8, True)],
                    dict(skip_steps=1, backoff_steps=1, lr_backoff=0.5, max_rollbacks=2))
    _same_events(out)
    events, w = out["port"]
    assert w == 7.0 and 0.5 in events["lr_seen"]
    assert sum("rolled back" in s for s in events["logs"]) == 2 and any("recovered" in s for s in events["logs"])


def test_trainloop_raises_after_max_rollbacks_as_jax(tmp_path):
    out = _run_both(tmp_path, lambda i: {"loss": float("nan")}, [(1, False), (50, True)],
                    dict(skip_steps=0, backoff_steps=0, lr_backoff=0.5, max_rollbacks=1))
    _same_events(out)
    assert "rollback" in out["port"][0]["raised1"]


@pytest.mark.parametrize("rollback_on_sdc", [True, False])
def test_the_sdc_channel_rolls_back_as_jax(tmp_path, rollback_on_sdc):
    """A detection in a completed step (counted in its step scope) rolls
    back to the last checkpoint and skips the data stream ahead, and the
    corrupt update never survives; with the channel off it sails through."""
    out = _run_both(tmp_path, lambda i: {"loss": 1.0, "sdc": i == 3}, [(3, False), (8, True)],
                    dict(max_rollbacks=2, rollback_on_sdc=rollback_on_sdc))
    _same_events(out)
    events, w = out["port"]
    if rollback_on_sdc:
        assert w == 8.0 and len(events["history1"]) == 5
        assert any("SDC detected" in s and "rolled back" in s for s in events["logs"])
    else:
        assert w == 1007.0


def test_the_sdc_channel_respects_max_rollbacks_as_jax(tmp_path):
    out = _run_both(tmp_path, lambda i: {"loss": 1.0, "sdc": True}, [(1, False), (50, True)],
                    dict(max_rollbacks=1, rollback_on_sdc=True))
    _same_events(out)
    assert "rollback" in out["port"][0]["raised1"]


def test_the_straggler_policy_saves_once_as_jax(tmp_path, monkeypatch):
    """on_straggler="checkpoint" does not save the same step twice through
    the periodic path: every step once, as in the JAX loop, which then
    saves the last step once more at its end; the port's loop does not
    repeat a save that already holds the end state (a deliberate
    difference: a full second write of the same tree)."""
    saves = {}
    for name, ft, ckpt_mod, zero in (("jax", jft, jckpt, jnp.zeros((), jnp.float32)),
                                     ("port", tft, tckpt, torch.zeros(()))):
        calls = saves.setdefault(name, [])
        orig = ckpt_mod.CheckpointManager.maybe_save

        def counting(self, step, tree, *, extra=None, force=False, orig=orig, calls=calls):
            calls.append((step, force))
            return orig(self, step, tree, extra=extra, force=force)

        monkeypatch.setattr(ckpt_mod.CheckpointManager, "maybe_save", counting)
        loop = ft.TrainLoop(_StubStep(name == "jax"), lambda i: {"loss": 1.0},
                            ckpt_mod.CheckpointManager(str(tmp_path / name), interval=1, keep=10),
                            watchdog=ft.StepWatchdog(threshold=0.0, min_samples=1, warmup_steps=0),
                            on_straggler="checkpoint")
        loop.run({"w": zero}, {"step": zero}, num_steps=3, resume=False, log_every=0, logger=lambda s: None)
    assert saves["port"] == saves["jax"][:-1] and saves["jax"][-1] == (3, True)
    per_step = {}
    for step, _ in saves["port"]:
        per_step[step] = per_step.get(step, 0) + 1
    assert per_step == {1: 1, 2: 1, 3: 1}


def test_watchdog_warmup_steps_excluded_as_jax():
    for ft in (tft, jft):
        wd = ft.StepWatchdog(threshold=2.0, min_samples=2, warmup_steps=2)
        assert [wd.observe(i, t) for i, t in ((1, 100.0), (2, 80.0), (3, 1.0), (4, 1.0))] == [None] * 4
        ev = wd.observe(5, 5.0)
        assert ev is not None and ev.median == pytest.approx(1.0)


def test_the_loop_state_resumes_with_the_checkpoint(tmp_path):
    """lr_scale, the nonfinite streak and the data offset ride in the
    checkpoint's extra, so a preempted run in an lr backoff resumes in it
    (the JAX loop restarts them at 1, 0, 0: the port's deliberate
    difference)."""
    stub = _StubStep(False)
    seen = []

    def batch_fn(i):
        seen.append(i)
        return {"loss": float("nan") if i in (1, 2) else 1.0}

    ckpt = tckpt.CheckpointManager(str(tmp_path), interval=1, keep=3)
    policy = tft.CorruptionPolicy(skip_steps=1, backoff_steps=5, lr_backoff=0.5)
    loop = tft.TrainLoop(stub, batch_fn, ckpt, corruption_policy=policy)
    params, opt = {"w": torch.zeros(())}, {"step": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(KeyboardInterrupt):
        loop.run(params, opt, num_steps=5, resume=False, fail_at=3, log_every=0, logger=lambda s: None)
    assert ckpt.last_extra == {} and tckpt.latest_step(str(tmp_path)) == 3
    logs = []
    loop.run(params, opt, num_steps=4, resume=True, log_every=0, logger=logs.append)
    assert logs[0] == "[ft] resumed from checkpoint at step 3"
    assert ckpt.last_extra == {"lr_scale": 0.5, "streak": 2, "data_offset": 0}
    assert stub.lr_seen[-1] == 0.5  # the resumed step still in the backoff


# ---------------------------------------------------------------------------
# the train loop on a reduced model: preempt, resume, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_resume_after_preemption_is_bitwise(tmp_path, fused):
    """Reduced qwen3-4b, sfc_cuda (the kernels' plain versions here): a run
    preempted at step 3 (checkpoints every 2 steps) and resumed into a model
    built from other weights gives the uninterrupted run's losses and final
    weights bitwise; the AdamW step count (the bias correction and the
    fused flush's stochastic-rounding salt) rides in the checkpoint."""
    cfg = dataclasses.replace(get_config("qwen3_4b").reduced(), n_layers=1)

    def trainer(seed):
        model, opt, step, _ = build_trainer(cfg, batch=2, seq=8, total_steps=5, seed=seed, gemm_backend="sfc_cuda",
                                            fused_optimizer=fused, device="cpu")
        return model, opt, tft.model_step(step)

    _, _, _, batch_fn = build_trainer(cfg, batch=2, seq=8, seed=0, device="cpu")
    losses = {}

    def run(seed, ckpt, **kw):
        model, opt, step = trainer(seed)
        events = []
        loop = tft.TrainLoop(step, batch_fn, ckpt, on_metrics=events.append)
        try:
            loop.run(dict(model.named_parameters()), opt, num_steps=5, log_every=0, logger=lambda s: None, **kw)
        except KeyboardInterrupt:
            pass
        return model, {e["step"]: e["loss"] for e in events}

    ref_model, losses["ref"] = run(0, None, resume=False)
    ckdir = str(tmp_path / "ck")
    _, losses["pre"] = run(0, tckpt.CheckpointManager(ckdir, interval=2), resume=False, fail_at=3)
    assert tckpt.latest_step(ckdir) == 2 and list(losses["pre"]) == [1, 2, 3]
    model, losses["post"] = run(7, tckpt.CheckpointManager(ckdir, interval=2), resume=True)
    assert losses["pre"] == {k: losses["ref"][k] for k in (1, 2, 3)}
    assert losses["post"] == {k: losses["ref"][k] for k in (3, 4, 5)}
    for (name, p), q in zip(model.named_parameters(), ref_model.parameters()):
        assert torch.equal(p, q), name


def test_train_cli_resumes_from_its_checkpoints(tmp_path, capsys):
    """``--ckpt-dir`` / ``--ckpt-every`` / ``--fail-at``: a preempted run
    and its resumption end on the uninterrupted run's final loss."""
    argv = ["--arch", "qwen3-4b", "--reduced", "--device", "cpu", "--backend", "sfc_cuda", "--steps", "4",
            "--batch", "2", "--seq", "8"]
    want = train_cli.main(argv)
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "1"]
    with pytest.raises(KeyboardInterrupt):
        train_cli.main(argv + ck + ["--fail-at", "2"])
    got = train_cli.main(argv + ck)
    assert got == want[2:] and "[ft] resumed from checkpoint at step 2" in capsys.readouterr().out
