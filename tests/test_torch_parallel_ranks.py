"""The port's parallel layer on 8 spawned gloo ranks on the CPU.

The five cases of ``tests/test_parallel.py`` on the same meshes and
shapes, held to the same oracles and tolerances, the oracles computed by
JAX in this process (not by its ``shard_map``): expert-parallel MoE on a
2 x 4 ("data", "model") mesh against the dense ``moe_forward`` (2e-4, no
drops at capacity factor 8); sequence-parallel decode on 2 x 4 against
``decode_attention_ref`` (2e-4), which it misses with its all-reduces
left out (a control); a GPipe pipeline of 4 stages x tp 2
against the stages run in sequence (2e-5); an elastic 4 x 2 -> 2 x 4
remesh, bit-exact; and ``plan_to_shardings`` for the dp 2 x tp 4 and pp 2
schemes.  Besides: ``layers.hints`` reading an active 2 x 4 mesh,
``shard_hint`` on a DTensor, and each rank's shard under
``spec_to_placements`` against the
indices JAX's ``NamedSharding`` gives its device (from one JAX process
with 8 host devices).

The ranks are fresh interpreters that import torch and the port only.
They meet through a ``FileStore`` in the test's directory (no port),
their process groups time out after 60 s, and the parent kills them and
fails once ``RANK_TIMEOUT`` has passed.
"""

import json
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import REPO, run_subprocess  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref  # noqa
from repro.layers import moe as JMoE  # noqa: E402

WORLD = 8
RANK_TIMEOUT = 240.0
# (mesh shape, axes, tensor shape, spec)
SPEC_CASES = [
    ((2, 4), ("data", "model"), (8, 12), ("data", "model")),
    ((2, 4), ("data", "model"), (8, 12), (None, "model")),
    ((2, 4), ("data", "model"), (16, 3), (("data", "model"), None)),
    ((2, 2, 2), ("pod", "data", "model"), (8, 6),
     (("pod", "data"), "model")),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4),
     (("pod", "data", "model"), None)),
    ((2, 2, 2), ("pod", "data", "model"), (4, 6), (None, "data")),
]
SCHEMES = ("dp2_tp4", "pp2")

RANK_MAIN = r'''
import datetime, json, sys, types
from unittest import mock
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(work + "/store", world),
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
try:
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch import configs as C
    from repro_torch.launch.mesh import make_mesh, mesh_context
    from repro_torch.layers import hints
    from repro_torch.layers.moe import MoEParams
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ep import moe_ep_forward
    from repro_torch.parallel.pipeline import make_pp_mesh, pipeline_forward
    from repro_torch.parallel.plan_sharding import plan_to_shardings
    from repro_torch.parallel.sharding import axis_sizes, spec_to_placements
    from repro_torch.parallel.sp_decode import sp_decode_attention
    from repro_torch.training.elastic import reshard_state

    inp = {k: torch.from_numpy(v) for k, v in np.load(work + "/in.npz").items()}
    meta = json.load(open(work + "/meta.json"))
    out, info = {}, {}
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")

    # expert parallelism: batch over data, sequence and experts over model
    moe = MoEParams(torch.nn.ParameterDict({
        n: torch.nn.Parameter(inp["moe_" + n])
        for n in ("router", "w_up", "w_gate", "w_down")}))
    mine = MoEParams(torch.nn.ParameterDict(
        {"router": moe["router"]} | {n: torch.nn.Parameter(moe[n][2 * mi:2 * mi + 2])
                                     for n in ("w_up", "w_gate", "w_down")}))
    x = inp["moe_x"]
    y, drop = moe_ep_forward(mine, x[di:di + 1, 2 * mi:2 * mi + 2],
                             int(meta["top_k"]), mesh, cap_factor=8.0)
    out["ep"] = y.detach()
    info["ep_drop"] = float(drop)

    # sequence-parallel decode: batch over data, cache slots over model
    b, s = slice(2 * di, 2 * di + 2), slice(16 * mi, 16 * mi + 16)
    sp_args = (inp["sp_q"][b], inp["sp_k"][b, s], inp["sp_v"][b, s],
               inp["sp_lens"][b], mesh)
    out["sp"] = sp_decode_attention(*sp_args)
    # control: the MAX and SUM combines left out (each rank normalises its
    # own slots only)
    with mock.patch.object(dist, "all_reduce", lambda *a, **k: None):
        out["sp_no_combine"] = sp_decode_attention(*sp_args)
    # control: the normaliser left out (the ranks' outputs summed by their
    # weights e^(lse - max lse), undivided)
    with mock.patch.object(torch, "clamp_min",
                           lambda den, lo: den.new_ones(den.shape)):
        out["sp_no_normaliser"] = sp_decode_attention(*sp_args)

    # GPipe: 4 stages x tp 2, one (d, d) weight a stage
    pp = make_pp_mesh(4, tp=2, device="cpu")
    out["pp"] = pipeline_forward(lambda w, h: torch.tanh(h @ w),
                                 inp["pp_w"][pp.get_local_rank("stage")],
                                 inp["pp_x"], pp, 4)

    # elastic: 4 x 2 -> 2 x 4 ("node failure" remesh)
    state = {"w": inp["el_w"], "b": inp["el_b"]}
    specs = {"w": ("data", "model"), "b": ("model",)}
    on_a = reshard_state(state, specs,
                         make_mesh((4, 2), ("data", "model"), device="cpu"))
    on_b = reshard_state(on_a, specs, mesh)
    out["el_w"], out["el_b"] = (on_b[k].full_tensor() for k in ("w", "b"))
    info["el_local"] = [list(on_a["w"].to_local().shape),
                        list(on_b["w"].to_local().shape)]

    # plan -> mesh
    cfg = C.get_reduced("internlm2-1.8b")
    params = T.init_params(torch.Generator(), cfg, device="meta")
    info["plan"] = {}
    for name, sch in meta["schemes"].items():
        mat = plan_to_shardings(types.SimpleNamespace(**sch), cfg, params,
                                device="cpu")
        info["plan"][name] = dict(
            shape=axis_sizes(mat.mesh), needs_pipeline=mat.needs_pipeline,
            pp_stages=mat.pp_stages, batch_spec=list(mat.batch_spec),
            n_specs=len(mat.param_specs),
            n_shardings=len(mat.param_shardings()))
    try:
        plan_to_shardings(types.SimpleNamespace(
            model_dp=2, pp_stages=1, stage_devices=8, total_devices=16),
            cfg, params, device="cpu")
        info["too_large"] = None
    except ValueError as e:
        info["too_large"] = str(e)

    # the hints read the active mesh, and nothing without one
    with mesh_context(mesh):
        info["model_axis"] = hints.mesh_axis_size("model")
        info["data_axes"] = list(hints.data_axis_names())
    info["off_mesh"] = [hints.mesh_axis_size("model"),
                        list(hints.data_axis_names())]

    # shard_hint: a replicated DTensor resharded, the indivisible entry
    # dropped; a plain tensor left as it is
    dt = distribute_tensor(torch.arange(48.0).reshape(8, 6), mesh,
                           [Replicate(), Replicate()])
    plain = torch.ones(4)
    with mesh_context(mesh):
        hinted = hints.shard_hint(dt, "data", "model")
        info["hint_plain_same"] = hints.shard_hint(plain, "data") is plain
    info["hint_placements"] = [str(p) for p in hinted.placements]
    out["hint_local"] = hinted.to_local()
    info["hint_off"] = hints.shard_hint(dt, "data") is dt

    # spec_to_placements: each rank's shard
    for i, (shape, axes, tshape, spec) in enumerate(meta["spec_cases"]):
        m = make_mesh(shape, axes, device="cpu")
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        full = torch.arange(float(np.prod(tshape))).reshape(tshape)
        out[f"spec{i}"] = distribute_tensor(
            full, m, spec_to_placements(spec, m)).to_local()

    np.savez(f"{work}/out_{rank}.npz",
             **{k: v.detach().numpy() for k, v in out.items()})
    with open(f"{work}/info_{rank}.json", "w") as f:
        json.dump(info, f)
finally:
    dist.destroy_process_group()
'''

JAX_INDICES = r'''
import json
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs as C
from repro.core import generate_schemes
from repro.models import transformer as T
from repro.parallel.plan_sharding import plan_to_shardings

cases = json.loads(CASES)
devs = jax.devices()
res = {"specs": [], "plans": {}}
for shape, axes, tshape, spec in cases:
    mesh = Mesh(np.array(devs[:int(np.prod(shape))]).reshape(shape),
                tuple(axes))
    spec = P(*(tuple(e) if isinstance(e, list) else e for e in spec))
    idx = NamedSharding(mesh, spec).devices_indices_map(tuple(tshape))
    res["specs"].append({str(d.id): [[s.start or 0, s.stop or n]
                                     for s, n in zip(sl, tshape)]
                         for d, sl in idx.items()})
cfg = C.get_reduced("internlm2_1_8b")
schemes = generate_schemes(cfg.to_ir(), 8)
params = jax.eval_shape(lambda: T.init_params(jax.random.PRNGKey(0), cfg))
dp_tp = [s for s in schemes if s.model_dp == 2 and s.pp_stages == 1
         and s.is_feasible_for_current_systems()][0]
pp = [s for s in schemes if s.pp_stages == 2 and s.model_dp == 1][0]
for name, s in (("dp2_tp4", dp_tp), ("pp2", pp)):
    mat = plan_to_shardings(s, cfg, params)
    res["plans"][name] = dict(
        shape=dict(mat.mesh.shape), needs_pipeline=mat.needs_pipeline,
        pp_stages=mat.pp_stages,
        scheme=dict(model_dp=s.model_dp, pp_stages=s.pp_stages,
                    stage_devices=s.stage_devices,
                    total_devices=s.total_devices))
print("RESULT" + json.dumps(res))
'''


def _inputs():
    """The numpy inputs of every case and JAX's oracles for them."""
    rng = np.random.default_rng(0)
    d, f, E, k = 16, 32, 8, 2
    moe = jax.device_get(JMoE.init_moe(jax.random.PRNGKey(0), d, f, E, k,
                                       dtype=jnp.float32))
    x = rng.standard_normal((2, 8, d)).astype(np.float32)
    logits = np.sort(x.reshape(-1, d) @ moe["router"], axis=-1)[:, ::-1]
    # fp32 routes of the two frameworks cannot flip away from a near-tie
    assert float((logits[:, k - 1] - logits[:, k]).min()) > 1e-4
    B, Hq, Hkv, D, Smax = 4, 8, 2, 16, 64
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kc = rng.standard_normal((B, Smax, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, Smax, Hkv, D)).astype(np.float32)
    lens = np.array([5, 17, 40, 64], np.int32)
    w = (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32)
    xm = rng.standard_normal((8, 2, 8, 16)).astype(np.float32)
    inp = {"moe_x": x, "sp_q": q, "sp_k": kc, "sp_v": vc, "sp_lens": lens,
           "pp_w": w, "pp_x": xm,
           "el_w": np.arange(64, dtype=np.float32).reshape(8, 8),
           "el_b": np.ones(8, np.float32)}
    inp.update({"moe_" + n: np.asarray(a) for n, a in moe.items()})
    seq = jnp.asarray(xm)
    for i in range(4):
        seq = jnp.tanh(seq @ w[i])
    oracle = {
        "ep": np.asarray(JMoE.moe_forward(moe, jnp.asarray(x), k)),
        "sp": np.asarray(decode_attention_ref(*map(jnp.asarray,
                                                   (q, kc, vc, lens)))),
        "pp": np.asarray(seq)}
    return inp, oracle, k


def _run_ranks(work, world):
    """Start ``world`` ranks of RANK_MAIN; fail on a rank's error or after
    RANK_TIMEOUT seconds, killing every rank still running."""
    script = os.path.join(work, "rank_main.py")
    with open(script, "w") as f:
        f.write(RANK_MAIN)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    logs = [open(os.path.join(work, f"rank_{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen([sys.executable, script, str(r), str(world),
                               work], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, log in enumerate(logs):
        log.seek(0)
        text.append(f"-- rank {r} (rc {procs[r].returncode}):\n"
                    + log.read()[-3000:])
        log.close()
    assert not hung, (f"ranks {hung} still running after {RANK_TIMEOUT} s\n"
                      + "\n".join(text))
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"ranks {bad} failed\n" + "\n".join(text)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ranks"))
    stdout = run_subprocess("CASES = " + repr(json.dumps(SPEC_CASES))
                            + "\n" + JAX_INDICES, devices=WORLD)
    want = json.loads(stdout.split("RESULT", 1)[1])
    inp, oracle, top_k = _inputs()
    np.savez(os.path.join(work, "in.npz"), **inp)
    with open(os.path.join(work, "meta.json"), "w") as f:
        json.dump({"top_k": top_k, "spec_cases": SPEC_CASES,
                   "schemes": {n: want["plans"][n]["scheme"]
                               for n in SCHEMES}}, f)
    _run_ranks(work, WORLD)
    outs = [dict(np.load(os.path.join(work, f"out_{r}.npz")))
            for r in range(WORLD)]
    infos = []
    for r in range(WORLD):
        with open(os.path.join(work, f"info_{r}.json")) as f:
            infos.append(json.load(f))
    return dict(inp=inp, oracle=oracle, want=want, outs=outs, infos=infos)


def _coords(rank):
    """(data, model) of ``rank`` on the 2 x 4 mesh."""
    return divmod(rank, 4)


def test_ep_matches_dense_oracle(ranks):
    for r, out in enumerate(ranks["outs"]):
        di, mi = _coords(r)
        assert ranks["infos"][r]["ep_drop"] == 0.0
        np.testing.assert_allclose(
            out["ep"], ranks["oracle"]["ep"][di:di + 1, 2 * mi:2 * mi + 2],
            rtol=2e-4, atol=2e-4)


def test_sp_decode_matches_ref(ranks):
    for r, out in enumerate(ranks["outs"]):
        di, _ = _coords(r)
        np.testing.assert_allclose(
            out["sp"], ranks["oracle"]["sp"][2 * di:2 * di + 2],
            rtol=2e-4, atol=2e-4)


def test_sp_decode_without_the_combine_misses_the_ref(ranks):
    """The control the card cannot show (its all-reduces are of size 1):
    without them, every rank's output leaves the tolerance."""
    for r, out in enumerate(ranks["outs"]):
        di, _ = _coords(r)
        want = ranks["oracle"]["sp"][2 * di:2 * di + 2]
        assert np.abs(out["sp_no_combine"] - want).max() > 2e-4 + \
            2e-4 * np.abs(want).max()


def test_sp_decode_without_the_normaliser_misses_the_ref(ranks):
    """The normaliser's control, which the card cannot show either (at
    world size 1 each weight is e^0): every rank holds a row whose valid
    slots span several ranks, and its output leaves the tolerance."""
    for r, out in enumerate(ranks["outs"]):
        di, _ = _coords(r)
        want = ranks["oracle"]["sp"][2 * di:2 * di + 2]
        assert np.abs(out["sp_no_normaliser"] - want).max() > 2e-4 + \
            2e-4 * np.abs(want).max()


def test_pipeline_matches_sequential(ranks):
    for out in ranks["outs"]:
        np.testing.assert_allclose(out["pp"], ranks["oracle"]["pp"],
                                   rtol=2e-5, atol=2e-5)


def test_elastic_reshard_roundtrip(ranks):
    for r, out in enumerate(ranks["outs"]):
        np.testing.assert_array_equal(out["el_w"], ranks["inp"]["el_w"])
        np.testing.assert_array_equal(out["el_b"], ranks["inp"]["el_b"])
        assert ranks["infos"][r]["el_local"] == [[2, 4], [4, 2]]


def test_plan_to_shardings(ranks):
    want = ranks["want"]["plans"]
    assert want["dp2_tp4"]["shape"] == {"data": 2, "model": 4}
    assert want["pp2"]["needs_pipeline"] and want["pp2"]["pp_stages"] == 2
    for info in ranks["infos"]:
        for name in SCHEMES:
            got = info["plan"][name]
            assert got["shape"] == want[name]["shape"]
            assert list(got["shape"]) == list(want[name]["shape"])
            assert got["needs_pipeline"] == want[name]["needs_pipeline"]
            assert got["pp_stages"] == want[name]["pp_stages"]
            assert got["n_specs"] == got["n_shardings"] > 0
        assert info["plan"]["dp2_tp4"]["batch_spec"] == ["data"]
        assert "16" in info["too_large"] and "8" in info["too_large"]


def test_hints_read_the_active_mesh(ranks):
    for info in ranks["infos"]:
        assert info["model_axis"] == 4 and info["data_axes"] == ["data"]
        assert info["off_mesh"] == [1, []]


def test_shard_hint_redistributes_dtensors(ranks):
    full = np.arange(48.0).reshape(8, 6)
    for r, (info, out) in enumerate(zip(ranks["infos"], ranks["outs"])):
        di, _ = _coords(r)
        assert info["hint_placements"] == ["S(0)", "R"]
        np.testing.assert_array_equal(out["hint_local"],
                                      full[4 * di:4 * di + 4])
        assert info["hint_plain_same"] and info["hint_off"]


@pytest.mark.parametrize("case", range(len(SPEC_CASES)))
def test_spec_to_placements_shards_match_jax(ranks, case):
    shape, _, tshape, _ = SPEC_CASES[case]
    full = np.arange(float(np.prod(tshape))).reshape(tshape)
    idx = ranks["want"]["specs"][case]
    assert len(idx) == int(np.prod(shape))
    for r in range(int(np.prod(shape))):
        want = full[tuple(slice(a, b) for a, b in idx[str(r)])]
        np.testing.assert_array_equal(ranks["outs"][r][f"spec{case}"], want)
