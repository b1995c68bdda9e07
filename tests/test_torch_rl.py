"""The port's learner, replay ring and batched transfer against meshdqn_tpu's,
on the CPU.

* train_step from the ys930 pack's latest checkpoint (converted:
  meshdqn_tpu_torch/data/ys930_ckpt_state.npz) on the committed fixture's
  pool of real transitions, in the 'copy'/'swap' x double/plain cases with
  and without target_clip, cql_alpha and grad_clip (binding and not): the
  port's f64 steps equal the JAX package's f64 steps (the JAX forward with
  its f32 cast removed) to f64 rounding, and its f32 steps deviate from
  them within 2x of the JAX f32 steps' own deviation (the losses' RMS, the
  parameter update's norm); the LR at the milestones; K steps at once equal
  K single steps;
* batched_forward against JAX's vmapped forward (2x rule against the f64
  evaluation, same argmax) and against the port's per-graph forward, with
  tied and all-zero scores;
* DeviceReplay against JAX's: pushes, flushes, wrap-around, more pushes
  between two flushes than the ring holds, sample_indices
  on one rng, the gathered batch, and a ring saved by either package loaded
  by the other;
* the batched transfer (f32 and f64 wire) and the batched window gather
  against JAX's.
"""
import dataclasses
import importlib.util
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meshdqn_tpu.env as jenv
import meshdqn_tpu.models as jmodels
import meshdqn_tpu.rl as jrl
import meshdqn_tpu.rl.dqn as jdqn
import meshdqn_tpu.transfer as jtransfer
import meshdqn_tpu.utils as jutils
import meshdqn_tpu_torch.env as tenv
import meshdqn_tpu_torch.models as tmodels
import meshdqn_tpu_torch.rl as trl
import meshdqn_tpu_torch.transfer as ttransfer
from meshdqn_tpu_torch.convert import dqn_state_from_numpy, dqn_state_to_numpy
from tests.torch_helpers import REPO, cap_threads

cap_threads()

DATA = REPO / "meshdqn_tpu_torch" / "data"
PACK = REPO / "checkpoints" / "ys930_results"
K = 3  # steps per case: with target_update=2 the copy / role swap lands before the third


def _script(name):
    sys.path.insert(0, str(REPO / "scripts"))
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CONVERT = _script("torch_convert_checkpoint")
FIXTURE = _script("torch_train_fixture")


@pytest.fixture(scope="module")
def fixture():
    with np.load(DATA / "ys930_train_fixture.npz") as z:
        fx = {k: z[k] for k in z.files}
    with np.load(DATA / "ys930_ckpt_state.npz") as z:
        state = {k: z[k] for k in z.files if k not in ("step", "extras_json")}
    cfg = json.loads(str(fx["dqn_config_json"]))
    cfg["milestones"] = tuple(cfg["milestones"])
    return fx, state, cfg


def _jax_batch(fx, idx):
    def graph(slot):
        return jenv.GraphState(*(jnp.asarray(fx[f"pool/{k}"][slot, idx])
                                 for k in ("x", "ei", "ea", "nm", "em")))
    return jrl.TransitionBatch(graph(0), jnp.asarray(fx["pool/action"][idx]), graph(1),
                               jnp.asarray(fx["pool/reward"][idx]),
                               jnp.asarray(fx["pool/non_final"][idx]))


def _store(fx):
    return trl.ReplayStore(**{k: torch.from_numpy(fx[f"pool/{k}"])
                              for k in trl.ReplayStore._fields})


def _jax_steps(state, fx, idx, cfg):
    losses = []
    for k in range(len(idx)):
        state, loss = jrl.train_step(state, _jax_batch(fx, idx[k]), cfg)
        losses.append(float(loss))
    return np.asarray(losses), CONVERT.dqn_state_arrays(state)


def _port_steps(arrays, fx, idx, cfg, dtype):
    st = dqn_state_from_numpy(arrays, cfg, "cpu", dtype)
    st, losses = trl.train_step_many_idx(st, _store(fx), torch.from_numpy(idx), cfg)
    return losses.numpy(), dqn_state_to_numpy(st)


def _params(arrays):
    keys = sorted(k for k in arrays if k.startswith("params"))
    return np.concatenate([np.asarray(arrays[k], np.float64).ravel() for k in keys])


def _grad_norm(arrays, fx, idx, cfg):
    st = dqn_state_from_numpy(arrays, cfg, "cpu", torch.float64)
    online = st.params1 if st.select else st.params2
    target = st.params2 if st.select else st.params1
    loss = trl.dqn_loss(online, target, trl.gather_batch(_store(fx), torch.from_numpy(idx)),
                        cfg)
    leaves = [t for _, t in trl.dqn.param_leaves(online)]
    return float(torch.sqrt(sum((g * g).sum() for g in torch.autograd.grad(loss, leaves))))


# (target_mode, double, target_clip, cql_alpha, grad_clip, select): the
# pack's config (its gradient clip of 10 binds on these batches: the
# gradient's norm is ~1e4), plain DQN with no clip nor CQL, a binding target
# clip with a gradient clip that does not bind, and net 2 online.
CASES = {
    "copy-double-pack": ("copy", True, 50.0, 0.03, 10.0, True),
    "copy-plain-bare": ("copy", False, 0.0, 0.0, 0.0, True),
    "swap-double-tclip": ("swap", True, 2.0, 0.1, 1e6, True),
    "swap-plain-net2": ("swap", False, 0.0, 0.0, 0.0, False),
}


def _case_cfg(base, case):
    mode, double, tclip, cql, gclip, _ = CASES[case]
    return dataclasses.replace(base, target_mode=mode, double=double, target_clip=tclip,
                               cql_alpha=cql, grad_clip=gclip, target_update=2)


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(fixture, monkeypatch, case):
    fx, state, cfg_dict = fixture
    jcfg = _case_cfg(jrl.DQNConfig(**cfg_dict), case)
    tcfg = trl.DQNConfig(**dataclasses.asdict(jcfg))
    arrays = dict(state, select=np.asarray(CASES[case][5]))
    idx = fx["idx"][:K]
    norm = _grad_norm(arrays, fx, idx[0], tcfg)
    if tcfg.grad_clip:
        assert (norm >= tcfg.grad_clip) == (case == "copy-double-pack"), norm

    l32, a32 = _jax_steps(CONVERT.jax_dqn_state(arrays, jcfg), fx, idx, jcfg)
    monkeypatch.setattr(jdqn, "forward", FIXTURE.forward_f64)
    l64, a64 = _jax_steps(CONVERT.jax_dqn_state(arrays, jcfg, jnp.float64), fx, idx, jcfg)
    t32, ta32 = _port_steps(arrays, fx, idx, tcfg, torch.float32)
    t64, ta64 = _port_steps(arrays, fx, idx, tcfg, torch.float64)

    for k in ("num_grads", "select", "opt1/count", "opt2/count", "opt1/schedule_count",
              "opt2/schedule_count"):
        assert ta32[k] == ta64[k] == a32[k] == a64[k], k
    # f64: the same arithmetic up to summation order.
    np.testing.assert_allclose(t64, l64, rtol=1e-12)
    before = _params(arrays)
    d64 = _params(a64) - before
    assert np.linalg.norm(_params(ta64) - before - d64) <= 1e-9 * np.linalg.norm(d64)
    # f32: within 2x of JAX's own deviation from the f64 steps.
    rms = lambda v: float(np.sqrt(np.mean(np.square(v))))  # noqa: E731
    dev_t, dev_j = rms((t32 - l64) / l64), rms((l32 - l64) / l64)
    assert dev_t <= 2 * dev_j, (dev_t, dev_j)
    upd = lambda a: np.linalg.norm(_params(a) - before - d64) / np.linalg.norm(d64)  # noqa: E731
    assert upd(ta32) <= 2 * upd(a32), (upd(ta32), upd(a32))
    assert dev_j < 1e-2 and upd(a32) < 1e-2  # the f32 steps are f32-accurate at all


@pytest.mark.parametrize("mode", ["copy", "swap"])
def test_lr_at_milestones(fixture, monkeypatch, mode):
    """One f64 step from Adam and schedule counts just below and at a
    milestone (halved under 'swap'): the same update as JAX's, so the LR
    switches at the same count; and 10x smaller at the milestone."""
    fx, state, cfg_dict = fixture
    case = "copy-plain-bare" if mode == "copy" else "swap-plain-net2"
    jcfg = _case_cfg(jrl.DQNConfig(**cfg_dict), case)
    tcfg = trl.DQNConfig(**dataclasses.asdict(jcfg))
    monkeypatch.setattr(jdqn, "forward", FIXTURE.forward_f64)
    m = trl.dqn.milestones(tcfg)[1]
    assert m == (1_000_000 if mode == "copy" else 500_000)
    net = "1" if CASES[case][5] else "2"
    norms = []
    for count in (m - 1, m):
        arrays = dict(state, select=np.asarray(CASES[case][5]))
        arrays[f"opt{net}/count"] = arrays[f"opt{net}/schedule_count"] = np.int32(count)
        before = _params(arrays)
        _, a64 = _jax_steps(CONVERT.jax_dqn_state(arrays, jcfg, jnp.float64), fx,
                            fx["idx"][:1], jcfg)
        _, t64 = _port_steps(arrays, fx, fx["idx"][:1], tcfg, torch.float64)
        d = _params(a64) - before
        assert np.linalg.norm(_params(t64) - before - d) <= 1e-9 * np.linalg.norm(d)
        norms.append(np.linalg.norm(d))
    assert 9 < norms[0] / norms[1] < 11


def test_train_step_many_equals_single_steps(fixture):
    fx, state, cfg_dict = fixture
    cfg = trl.DQNConfig(**cfg_dict)
    idx = torch.from_numpy(fx["idx"])
    a = dqn_state_from_numpy(state, cfg, "cpu")
    a, losses = trl.train_step_many_idx(a, _store(fx), idx, cfg)
    b = dqn_state_from_numpy(state, cfg, "cpu")
    singles = [trl.train_step_idx(b, _store(fx), idx[k], cfg)[1] for k in range(len(idx))]
    assert torch.equal(losses, torch.stack(singles))
    for x, y in zip(dqn_state_to_numpy(a).values(), dqn_state_to_numpy(b).values()):
        np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------------
# batched_forward
# ----------------------------------------------------------------------

def _graphs(fx):
    """The pool's 64 states and next states, a state with tied rows, and an
    all-zero state (every pooling score ties)."""
    x = np.concatenate([fx["pool/x"][0], fx["pool/x"][1][:8]])
    g = {k: np.concatenate([fx[f"pool/{k}"][0], fx[f"pool/{k}"][1][:8]])
         for k in ("ei", "ea", "nm", "em")}
    x[1, 5] = x[1, 9] = x[1, 12]
    x[2] = 0.0
    return jenv.GraphState(x, g["ei"], g["ea"], g["nm"], g["em"])


@pytest.mark.parametrize("head", ["linear", "softmax"])
def test_batched_forward(fixture, head):
    fx, state, cfg_dict = fixture
    leaves = {k[len("params1/"):]: v for k, v in state.items() if k.startswith("params1/")}
    jp = {}
    for path, v in leaves.items():
        layer, name = path.split("/")
        jp.setdefault(layer, {})[name] = jnp.asarray(v)
    tp = dqn_state_from_numpy(state, trl.DQNConfig(**cfg_dict), "cpu").params1
    gs = _graphs(fx)
    qj = np.asarray(jax.jit(lambda p, g: jmodels.batched_forward(p, g, topk=0.1, head=head))(
        jp, jenv.GraphState(*(jnp.asarray(a) for a in gs))))
    p64 = jax.tree.map(lambda a: a.astype(jnp.float64), jp)
    q64 = np.asarray(jax.jit(jax.vmap(lambda g: FIXTURE.forward_f64(p64, g, 0.1, head=head)))(
        jenv.GraphState(*(jnp.asarray(a) for a in gs))))
    tg = tenv.GraphState(*(torch.from_numpy(np.asarray(a)) for a in gs))
    with torch.no_grad():
        qt = tmodels.batched_forward(tp, tg, topk=0.1, head=head).numpy()
        single = np.stack([tmodels.forward(tp, tenv.GraphState(*(t[b] for t in tg)), topk=0.1,
                                           head=head).numpy() for b in range(len(qt))])
    scale = np.abs(q64).max(axis=1, keepdims=True)
    dev_t = np.abs(qt - q64).max(axis=1) / scale[:, 0]
    dev_j = np.abs(qj - q64).max(axis=1) / scale[:, 0]
    rms = lambda v: float(np.sqrt(np.mean(np.square(v))))  # noqa: E731
    assert rms(dev_t) <= 2 * rms(dev_j), (rms(dev_t), rms(dev_j))
    np.testing.assert_array_equal(qt.argmax(1), q64.argmax(1))
    np.testing.assert_array_equal(qj.argmax(1), q64.argmax(1))
    # The batch against the per-graph forward, by the same rule.
    dev_s = np.abs(single - q64).max(axis=1) / scale[:, 0]
    assert rms(dev_t) <= 2 * rms(dev_s), (rms(dev_t), rms(dev_s))
    np.testing.assert_array_equal(qt.argmax(1), single.argmax(1))
    assert np.isfinite(qt[2]).all()


def test_topk_pool_batched_equals_per_graph():
    """The pooled graphs of a batch, tied and all-zero scores included, equal
    each graph's own pooling (selection, masks and edges exactly)."""
    rng = np.random.default_rng(0)
    B, n, e, f = 4, 40, 200, 17
    x = rng.standard_normal((B, n, f)).astype(np.float32)
    x[1, 5] = x[1, 9] = x[1, 12]
    x[2] = 0.0
    ei = rng.integers(0, 31, (B, 2, e)).astype(np.int32)
    nm = np.arange(n)[None] < np.array([31, 40, 25, 1])[:, None]
    em = np.arange(e)[None] < np.array([150, 200, 90, 0])[:, None]
    w = rng.standard_normal(f).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, ei, em, nm)]
    batched = tmodels.topk_pool({"w": torch.from_numpy(w)}, *args, 0.5, 20)
    for b in range(B):
        one = tmodels.topk_pool({"w": torch.from_numpy(w)}, *(a[b] for a in args), 0.5, 20)
        jone = jmodels.topk_pool({"w": jnp.asarray(w)}, *(jnp.asarray(a[b]) for a in
                                                           (x, ei, em, nm)), 0.5, 20)
        for t, s, j in zip(batched, one, jone):
            np.testing.assert_array_equal(t[b].numpy(), s.numpy())
            if t.dtype != torch.float32:
                np.testing.assert_array_equal(s.numpy(), np.asarray(j))


# ----------------------------------------------------------------------
# DeviceReplay
# ----------------------------------------------------------------------

def _transitions(fx, n):
    """n (state, action, next|None, reward) from the pool, terminals kept."""
    def graph(slot, i):
        return jenv.GraphState(*(fx[f"pool/{k}"][slot, i] for k in ("x", "ei", "ea", "nm",
                                                                       "em")))
    return [(graph(0, i), int(fx["pool/action"][i]),
             graph(1, i) if fx["pool/non_final"][i] else None, float(fx["pool/reward"][i]))
            for i in range(n)]


def test_device_replay_matches_jax(fixture, tmp_path):
    fx = fixture[0]
    n, f, e = fx["pool/x"].shape[2], fx["pool/x"].shape[3], fx["pool/ea"].shape[2]
    jr = jrl.DeviceReplay(8, n, f, e)
    tr = trl.DeviceReplay(8, n, f, e)
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    trans = _transitions(fx, 21)
    assert any(t[2] is None for t in trans)
    for chunk in (trans[:5], trans[5:6], trans[6:19], trans[19:]):  # the ring wraps
        for t in chunk:
            jr.push(*t)
            tr.push(*t)
        ij, it = jr.sample_indices(4, rj), tr.sample_indices(4, rt)
        np.testing.assert_array_equal(ij, it)
        jr.flush()
        tr.flush()
        assert len(jr) == len(tr)
        for name in trl.ReplayStore._fields:
            np.testing.assert_array_equal(getattr(tr.store, name).numpy(),
                                          np.asarray(getattr(jr.store, name)), name)
        jb = jrl.gather_batch(jr.store, jnp.asarray(ij))
        tb = trl.gather_batch(tr.store, torch.from_numpy(it))
        for a, b in zip(jax.tree_util.tree_leaves(jb), jax.tree_util.tree_leaves(
                [tuple(tb.state), tb.action, tuple(tb.next_state), tb.reward, tb.non_final])):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    # A ring saved by either package loads in the other.
    tr.save(str(tmp_path / "port.npz"))
    jr.save(str(tmp_path / "jax.npz"))
    j2, t2 = jrl.DeviceReplay(8, n, f, e), trl.DeviceReplay(8, n, f, e)
    assert j2.load(str(tmp_path / "port.npz")) and t2.load(str(tmp_path / "jax.npz"))
    assert (len(j2), j2._pos) == (len(t2), t2._pos) == (len(tr), tr._pos)
    for name in trl.ReplayStore._fields:
        np.testing.assert_array_equal(getattr(t2.store, name).numpy(),
                                      np.asarray(getattr(j2.store, name)), name)
    assert not trl.DeviceReplay(4, n, f, e).load(str(tmp_path / "jax.npz"))


def test_device_replay_overfull_flush_matches_jax(fixture):
    """More transitions staged between two flushes than the ring holds: the
    later pushes win each slot, as in JAX's ring."""
    fx = fixture[0]
    n, f, e = fx["pool/x"].shape[2], fx["pool/x"].shape[3], fx["pool/ea"].shape[2]
    jr, tr = jrl.DeviceReplay(8, n, f, e), trl.DeviceReplay(8, n, f, e)
    for chunk in (_transitions(fx, 3), _transitions(fx, 19)[3:]):
        for t in chunk:
            jr.push(*t)
            tr.push(*t)
        jr.flush()
        tr.flush()
        assert (len(jr), jr._pos) == (len(tr), tr._pos)
        for name in trl.ReplayStore._fields:
            np.testing.assert_array_equal(getattr(tr.store, name).numpy(),
                                          np.asarray(getattr(jr.store, name)), name)


# ----------------------------------------------------------------------
# The batched transfer
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def removal_inputs():
    """The pack env's device-pass inputs of 5 removals from 3 meshes (the
    stock mesh and two coarsened ones), and window-shift items."""
    cfg = jutils.Config.from_yaml(str(PACK / "config.yaml"))
    env = jenv.AirfoilEnv(cfg, ground_truth=jenv.GroundTruth.load(str(PACK / "ground_truth.npz")))
    inputs = []
    for pre in ([], [0], [0, 3]):
        env.reset()
        for a in pre:
            env.step(a)
        for a in (1, 5) if len(pre) < 2 else (2,):
            snap = env.snapshot_state()
            prep = env.prepare_step(a)
            assert prep.inputs is not None
            inputs.append(prep.inputs)
            env.restore_state(snap)
    return cfg, inputs


@pytest.mark.parametrize("wire", ["f32", "f64"])
def test_run_products_batched_matches_jax(removal_inputs, wire):
    cfg, inputs = removal_inputs
    gt = jenv.GroundTruth.load(str(PACK / "ground_truth.npz"))
    jt = jtransfer.SnapshotTransfer(gt.mesh, gt.snapshots, window_budget=180)
    tgt = tenv.GroundTruth.load(str(PACK / "ground_truth.npz"))
    tt = ttransfer.SnapshotTransfer(tgt.mesh, tgt.snapshots, window_budget=180, device="cpu")
    jout = jt.run_products_batched(inputs, pad_to=8, wire=wire)
    tout = tt.run_products_batched_finish(tt.run_products_batched_begin(inputs, wire=wire))
    for j, t in zip(jout, tout):
        assert j[1] == t[1]
        for a, b in zip(j[2:], t[2:]):
            np.testing.assert_allclose(b, a, rtol=1e-9, atol=0)
    # Window shifts on the removals' interpolants (kept on the device),
    # batched: each removal's window shifted by one vertex.  The windows hold
    # removable (interior) vertices only.  On the f32 wire a few boundary
    # vertices land off their cell corners, where the f32 candidate sweep
    # may pick another adjacent cell than XLA's contraction does; no window
    # reads those.
    wins = [inp["widx"][1 + i: inp["k"]] for i, inp in enumerate(inputs[:3])]
    for a, b in zip(jt.gather_window_batched([(j[0], w) for j, w in zip(jout, wins)], pad_to=4),
                    tt.gather_window_batched_finish(tt.gather_window_batched_begin(
                        [(t[0], w) for t, w in zip(tout, wins)]))):
        for x, y in zip(a, b):
            assert y.shape == x.shape
            np.testing.assert_allclose(y, x, rtol=1e-9, atol=1e-12 * np.abs(x).max())
