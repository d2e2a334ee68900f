"""repro_torch.ckpt and the trainer's checkpoint/restart against the JAX
package's repro.ckpt and repro.train.

First the reference's checkpoint tests run on the port:
``tests/test_substrate.py::TestCheckpoint`` (round trip, uncommitted
checkpoints ignored, keep-last-k, async save; its mesh re-shard case does
not apply: the port restores onto one device and has no meshes yet) and
``tests/test_faults.py::TestCheckpointBytes`` (meta tensors for the abstract
case) and ``::TestCheckpointManagerWait``.

Then across packages, for the tinyllama smoke config in float32 and in
bfloat16: the reference's checkpoint of the JAX trainer state restores in
the port ``==`` to ``convert`` of that state, the port's checkpoint of it
restores in ``repro.ckpt`` ``==`` to the JAX state, and the two
directories hold equal manifests and byte-equal ``.npy`` files.

Last the trainer: ``fit`` to 4 steps against ``fit`` to 2 and a fresh
trainer's ``fit`` to 4, bit-equal on the CPU; and both packages' trainers
resumed from the same checkpoint, agreeing within
``tests/test_torch_train.py``'s tolerances, including the reference's
resume on batch 0 of a fresh ``iter(SyntheticLM(...))``.
"""

import filecmp
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

import repro.ckpt as ref_ckpt  # noqa: E402
import repro.configs as ref_configs  # noqa: E402
from repro import data as ref_data  # noqa: E402
from repro import optim as ref_optim  # noqa: E402
from repro import train as ref_train  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.ckpt import (CheckpointManager, checkpoint_bytes,  # noqa: E402
                              latest_step, restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (opt_state_to_jax, params_to_jax,  # noqa: E402
                                 state_from_reference, state_to_reference)
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.faults import RecoveryModel, demo_scenario  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.optim.adamw import _flat_buffer  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

ARCH = "tinyllama-1.1b"


def _named(tree, prefix=""):
    """{dotted path: leaf} of a nested dict/list tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_named(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _np(x) -> np.ndarray:
    """A leaf of either package as numpy, bfloat16 carried as float32."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).detach().numpy()
    a = np.asarray(jax.device_get(x))
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _equal_states(got, want):
    """Port states leaf for leaf: same dtype, bit-equal values."""
    got, want = _named(got), _named(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------ tests/test_substrate.py twins
class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(6).reshape(2, 3).to(torch.bfloat16),
                "b": {"c": torch.ones(4, dtype=torch.float32)}}
        save_checkpoint(str(tmp_path), 7, tree)
        out, step = restore_checkpoint(str(tmp_path), tree)
        assert step == 7
        np.testing.assert_array_equal(out["a"].float().numpy(),
                                      tree["a"].float().numpy())
        assert out["a"].dtype == torch.bfloat16

    def test_uncommitted_ignored(self, tmp_path):
        tree = {"a": torch.ones(3)}
        p = save_checkpoint(str(tmp_path), 1, tree)
        os.remove(os.path.join(p, "COMMIT"))
        assert latest_step(str(tmp_path)) is None

    def test_keep_last_k(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in range(5):
            mgr.save(s, {"a": torch.full((2,), s)})
        assert mgr.latest_step() == 4
        out, _ = mgr.restore_latest({"a": torch.zeros(2)})
        np.testing.assert_array_equal(out["a"].numpy(), [4, 4])
        steps = sorted(os.listdir(tmp_path))
        assert len([s for s in steps if s.startswith("step_")]) == 2

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save_async(3, {"a": torch.ones(4)})
        mgr.wait()
        assert mgr.latest_step() == 3


def test_async_save_snapshots_before_returning(tmp_path):
    """A CPU tensor updated in place right after ``save_async`` returns (as
    the port's AdamW updates m and v) is saved as it was at the call."""
    mgr = CheckpointManager(str(tmp_path))
    m = torch.arange(1 << 16, dtype=torch.float32)
    mgr.save_async(0, {"m": m, "v": [m[:4]]})
    m.mul_(-1.0)
    mgr.wait()
    out, _ = mgr.restore_latest({"m": m, "v": [m[:4]]})
    assert torch.equal(out["m"], -m) and torch.equal(out["v"][0], -m[:4])


def test_restore_onto_device_and_dtype_of_like(tmp_path):
    save_checkpoint(str(tmp_path), 2, {"w": np.arange(6, dtype=np.float32),
                                       "n": np.int32(5)})
    like = {"w": torch.empty(6, dtype=torch.bfloat16, device="meta"),
            "n": torch.empty((), dtype=torch.int64, device="meta")}
    out, step = restore_checkpoint(str(tmp_path), like, device="cpu")
    assert step == 2 and out["w"].device.type == "cpu"
    assert out["w"].dtype == torch.bfloat16 and out["n"].dtype == torch.int64
    assert out["w"].float().tolist() == list(range(6)) and int(out["n"]) == 5
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), like)


# ---------------------------------------------- tests/test_faults.py twins
class TestCheckpointBytes:
    def test_matches_on_disk_payload(self, tmp_path):
        tree = {"w": np.ones((64, 32), np.float32),
                "b": np.ones((32,), np.float16),
                "step": np.int64(3),
                "bf": torch.ones((16, 8), dtype=torch.bfloat16)}
        est = checkpoint_bytes(tree)
        path = save_checkpoint(str(tmp_path), 0, tree)
        on_disk = 0
        for name in os.listdir(path):
            if name.endswith(".npy"):
                arr = np.load(os.path.join(path, name))
                on_disk += arr.nbytes
        assert est == on_disk
        # bf16 rides a float32 carrier: 16*8*4 bytes, not *2
        assert est == 64 * 32 * 4 + 32 * 2 + 8 + 16 * 8 * 4

    def test_abstract_leaves_size_without_materializing(self):
        tree = {"w": torch.empty((128, 256), dtype=torch.float32,
                                 device="meta")}
        assert checkpoint_bytes(tree) == 128 * 256 * 4

    def test_seeds_recovery_restore_cost(self):
        scn = demo_scenario(workers=2)
        tree = {"w": np.zeros((1000,), np.float64)}
        rec = RecoveryModel.from_scenario(scn, params_tree=tree)
        assert rec.checkpoint_bytes == 8000
        assert rec.restore_s == pytest.approx(
            8000 / rec.ckpt_bandwidth + rec.ckpt_latency_s)


class TestCheckpointManagerWait:
    def test_async_error_surfaces_once_and_unwedges(self, tmp_path,
                                                    monkeypatch):
        import repro_torch.ckpt.checkpoint as ckpt_mod
        mgr = ckpt_mod.CheckpointManager(str(tmp_path / "ck"))
        boom = RuntimeError("disk full")

        def failing_save(step, tree, **meta):
            raise boom

        monkeypatch.setattr(mgr, "save", failing_save)
        mgr.save_async(1, {"w": np.ones(4)})
        with pytest.raises(RuntimeError, match="disk full"):
            mgr.wait()
        # the error surfaced exactly once; the manager is not wedged
        mgr.wait()
        monkeypatch.undo()
        mgr.save_async(2, {"w": np.ones(4)})
        mgr.wait()
        assert mgr.latest_step() == 2


# ----------------------------------------------------- across packages
@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def states(request):
    """(port config, JAX trainer state after 2 steps, the port's state
    converted from it) for the smoke config in one dtype."""
    jcfg = ref_configs.get_smoke_config(ARCH).with_(dtype=request.param)
    cfg = get_smoke_config(ARCH).with_(dtype=request.param)
    jopt = ref_optim.AdamW(lr=1e-3)
    params = ref_build_model(jcfg).init(jax.random.PRNGKey(0))
    jstate = {"params": params, "opt": jopt.init(params),
              "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(ref_make_train_step(jcfg, jopt))
    for i in range(2):
        b = ref_data.make_batch(jcfg, seq_len=16, batch=2, step=i)
        jstate, _ = step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    state = state_from_reference(cfg, jax.device_get(jstate), "cpu")
    return cfg, jstate, state


def _like(cfg):
    """The reference-layout state on meta tensors (``restore_or_init``'s)."""
    return state_to_reference(cfg, Trainer(cfg, TrainerConfig(), device="cpu")
                              .init_state("meta"))


def test_checkpoint_bytes_equal_reference(states):
    cfg, jstate, state = states
    want = ref_ckpt.checkpoint_bytes(jstate)
    assert checkpoint_bytes(state) == want
    assert checkpoint_bytes(state_to_reference(cfg, state)) == want
    assert checkpoint_bytes(_like(cfg)) == want


def test_reference_checkpoint_restores_in_port(states, tmp_path):
    cfg, jstate, state = states
    ref_ckpt.save_checkpoint(str(tmp_path), 1, jstate)
    tree, step = restore_checkpoint(str(tmp_path), _like(cfg), device="cpu")
    got = state_from_reference(cfg, tree, "cpu")
    assert step == 1 and int(got["step"]) == 2
    _equal_states(got, state)
    m = tree_leaves(got["opt"]["m"])
    assert _flat_buffer(m).numel() == sum(t.numel() for t in m)   # flat-backed
    assert got["params"]["embed"]["table"].dtype == getattr(torch, cfg.dtype)


def test_port_checkpoint_restores_in_reference(states, tmp_path):
    cfg, jstate, state = states
    save_checkpoint(str(tmp_path), 1, state_to_reference(cfg, state))
    got, step = ref_ckpt.restore_checkpoint(str(tmp_path), jstate)
    assert step == 1
    flat_got, flat_want = jax.tree_util.tree_flatten_with_path(got)[0], \
        jax.tree_util.tree_flatten_with_path(jstate)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=str(path))


def test_manifests_equal_and_npy_byte_equal(states, tmp_path):
    cfg, jstate, state = states
    a = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 1, jstate)
    b = save_checkpoint(str(tmp_path / "port"), 1,
                        state_to_reference(cfg, state))
    with open(os.path.join(a, "manifest.json")) as fa, \
            open(os.path.join(b, "manifest.json")) as fb:
        ma, mb = json.load(fa), json.load(fb)
    assert ma == mb
    assert {v["dtype"] for v in ma["leaves"].values()} == (
        {cfg.dtype, "float32", "int32"})
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == len(ma["leaves"]) + 2
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


def test_numpy_converters_equal_reference_trees(states):
    cfg, jstate, state = states
    host = jax.device_get(jstate)
    for got, want in ((params_to_jax(cfg, state["params"]), host["params"]),
                      (opt_state_to_jax(cfg, state["opt"]), host["opt"])):
        got, want = _named(got), _named(want)
        assert sorted(got) == sorted(want)
        for k in want:
            assert isinstance(got[k], np.ndarray)
            assert got[k].dtype == _np(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], _np(want[k]), err_msg=k)


# ----------------------------------------------------------- trainer
@pytest.mark.parametrize("dtype,fused,ckpt_async", [
    ("bfloat16", False, True), ("bfloat16", True, False),
    ("float32", True, True)])
def test_trainer_resume_bit_equal(tmp_path, dtype, fused, ckpt_async):
    """``fit`` to 4 steps with a checkpoint every 2 against ``fit`` to 2
    and a fresh trainer's ``fit`` to 4 on the batches from step 2."""
    cfg = get_smoke_config(ARCH).with_(dtype=dtype)
    data = SyntheticLM(cfg.vocab, 16, 2)

    def trainer(steps, d):
        return Trainer(cfg, TrainerConfig(steps=steps, log_every=0,
                                          ckpt_every=2, ckpt_dir=str(d),
                                          ckpt_async=ckpt_async),
                       optimizer=AdamW(lr=1e-3, fused=fused), device="cpu")

    full = trainer(4, tmp_path / "full").fit(iter(data))
    first = trainer(2, tmp_path / "split")
    first.fit(iter(data))
    second = trainer(4, tmp_path / "split")
    resumed = second.fit(data.batch_at(i) for i in range(2, 4))
    assert [m["step"] for m in first.metrics_log] == [0, 1]
    assert [m["step"] for m in second.metrics_log] == [2, 3]
    assert int(resumed["step"]) == 4 and int(resumed["opt"]["count"]) == 4
    _equal_states(resumed, full)
    assert latest_step(str(tmp_path / "split")) == 3


def _ref_trainer(jcfg, steps, d):
    return ref_train.Trainer(jcfg, ref_train.TrainerConfig(
        steps=steps, log_every=0, ckpt_every=2, ckpt_dir=str(d)),
        optimizer=ref_optim.AdamW(lr=1e-3))


def _port_trainer(cfg, steps, d):
    return Trainer(cfg, TrainerConfig(steps=steps, log_every=0, ckpt_every=2,
                                      ckpt_dir=str(d)),
                   optimizer=AdamW(lr=1e-3), device="cpu")


def _close_to_reference(state, jstate, cfg):
    """``tests/test_torch_train.py``'s tolerances for 3 train steps: params
    99.9% of entries within 1e-6 and all within 1e-4; m within 1e-4 and v
    within 1e-3 of their largest entries; step and count exact."""
    want = state_from_reference(cfg, jax.device_get(jstate), "cpu")
    assert int(state["step"]) == int(want["step"])
    assert int(state["opt"]["count"]) == int(want["opt"]["count"])
    jp = _named(want["params"])
    d = np.concatenate([np.abs(_np(t) - _np(jp[k])).ravel()
                        for k, t in _named(state["params"]).items()])
    assert d.max() <= 1e-4 and (d <= 1e-6).mean() >= 0.999
    for tree, tol in (("m", 1e-4), ("v", 1e-3)):
        got, ref = _named(state["opt"][tree]), _named(want["opt"][tree])
        for k in ref:
            w = _np(ref[k])
            np.testing.assert_allclose(_np(got[k]), w,
                                       atol=tol * np.abs(w).max(), err_msg=k)


def test_resume_matches_reference_trainer_with_batch_zero(tmp_path):
    """Both packages' trainers start from the same step-0 checkpoint (the
    JAX init, written by the reference) and run 3 steps straight, and 2
    steps then a fresh trainer to 3 on a fresh ``iter(SyntheticLM)``: the
    resumed step 2 trains on batch 0 in both (the reference's behaviour,
    kept), so the resumed state differs from the straight one, and each
    package's runs agree with the other's within the tolerances
    ``tests/test_torch_train.py`` states for 3 steps."""
    jcfg = ref_configs.get_smoke_config(ARCH).with_(dtype="float32")
    cfg = get_smoke_config(ARCH).with_(dtype="float32")
    jopt = ref_optim.AdamW(lr=1e-3)
    params = ref_build_model(jcfg).init(jax.random.PRNGKey(0))
    init = {"params": params, "opt": jopt.init(params),
            "step": jnp.zeros((), jnp.int32)}
    for pkg in ("ref", "port"):
        for run in ("full", "split"):
            ref_ckpt.save_checkpoint(str(tmp_path / pkg / run), 0, init)
    ref_ds = ref_data.SyntheticLM(jcfg.vocab, 16, 2)
    port_ds = SyntheticLM(cfg.vocab, 16, 2)

    ref_full = _ref_trainer(jcfg, 3, tmp_path / "ref" / "full").fit(iter(ref_ds))
    _ref_trainer(jcfg, 2, tmp_path / "ref" / "split").fit(iter(ref_ds))
    ref_split = _ref_trainer(jcfg, 3, tmp_path / "ref" / "split").fit(iter(ref_ds))
    port_full = _port_trainer(cfg, 3, tmp_path / "port" / "full").fit(iter(port_ds))
    _port_trainer(cfg, 2, tmp_path / "port" / "split").fit(iter(port_ds))
    resumed = _port_trainer(cfg, 3, tmp_path / "port" / "split")
    port_split = resumed.fit(iter(port_ds))

    assert [m["step"] for m in resumed.metrics_log] == [2]
    _close_to_reference(port_full, ref_full, cfg)
    _close_to_reference(port_split, ref_split, cfg)
    # the resumed run trained step 2 on batch 0, not 2
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(port_split["params"]), tree_leaves(port_full["params"])))
    assert diff > 1e-3
    # and it is batch 0 on the step-1 checkpoint, bit for bit
    tree, _ = restore_checkpoint(str(tmp_path / "port" / "split"), _like(cfg),
                                 step=1, device="cpu")
    save_checkpoint(str(tmp_path / "port" / "replay"), 1, tree)
    replay = _port_trainer(cfg, 3, tmp_path / "port" / "replay")
    _equal_states(replay.fit(iter([port_ds.batch_at(0)])),
                  port_split)
