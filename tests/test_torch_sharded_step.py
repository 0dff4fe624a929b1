"""The mesh-wide sharded train step of the port on 8 spawned gloo ranks
(a 2 x 4 ("data", "model") mesh, the CPU), the path of the reference's
``tests/test_parallel.py::test_distributed_train_step_runs``.

REDUCED internlm2-1.8b in fp32 with the reference's weights
(``params_from_jax``): parameters sharded by ``param_pspecs(fsdp=True)``
as DTensors, an AdamW state sharded alike, the batch (4, 16) on "data";
one ``make_train_step(microbatches=1, remat=True)`` step.  Besides:
deepseek-v2-lite-16b REDUCED's expert-sharded einsum (8 experts on
"model" 4), qwen2-0.5b REDUCED's batch reshard around attention (7 heads
do not divide 4), and a sharded decode (sequence-sharded caches written
in place; each rank's attention through the decode kernel's wrapper over
its own slots, the outputs merged by their log-sum-exp).

Tolerances (fp32; read on the CPU): the sharded step's loss against the
port's single-rank step 1e-5 (read 4.8e-7) and its grad norm rtol 1e-5
(read 0); updated parameters and masters 1e-6 (read 6.0e-8: each rank's
products sum in another order, and the first AdamW step moves a
parameter by lr times about the gradient's sign, 3e-6 here, so a
gradient's wrong sign or scale shows); the single-rank loss against the
JAX single-device step 1e-5 (read 9.5e-7; the reference's test allows
5e-2).  Sharded against dense results (the expert einsum against the
expert loop, qwen2 logits, decode logits and K caches): 1e-5 (read at
most 2.4e-6).

The ranks are fresh interpreters that import torch and the port only
(``tests/test_torch_parallel_ranks.py``'s spawner): a ``FileStore`` in
the test's directory, process groups that time out after 60 s, and a
parent that kills them all and fails after ``RANK_TIMEOUT``.
"""

import dataclasses
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

from conftest import REPO  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

WORLD = 8
RANK_TIMEOUT = 240.0
ARCH = "internlm2-1.8b"

RANK_MAIN = r'''
import copy, dataclasses, datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(work + "/store", world),
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
try:
    from torch.distributed.tensor import DTensor, Replicate, Shard, \
        distribute_tensor
    from repro_torch import configs as C
    from repro_torch.launch.mesh import make_mesh, mesh_context
    from repro_torch.launch.steps import make_train_step
    from repro_torch.layers import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import (cache_pspecs,
                                               distribute_params,
                                               param_pspecs,
                                               spec_to_placements)
    from repro_torch.training.optimizer import adamw_init

    inp = dict(np.load(work + "/in.npz"))
    out, info = {}, {}
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")

    def fp32(arch):
        return dataclasses.replace(C.get_reduced(arch), dtype="float32")

    def model(arch, prefix=None):
        cfg = fp32(arch)
        p = T.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
        if prefix:
            with torch.no_grad():
                for n, t in p.named_parameters():
                    t.copy_(torch.from_numpy(inp[prefix + n]))
        return cfg, p

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    def put(x, spec):
        return distribute_tensor(x, mesh, spec_to_placements(spec, mesh))

    # the sharded train step
    cfg, params = model("internlm2-1.8b", "p/")
    pspecs = param_pspecs(params, cfg, mesh, fsdp=True)
    distribute_params(params, pspecs, mesh)
    opt = adamw_init(params)
    batch = {k: put(torch.from_numpy(inp[k]), ("data", None))
             for k in ("tokens", "labels")}
    with mesh_context(mesh):
        params, opt, metrics = make_train_step(
            cfg, microbatches=1, remat=True)(params, opt, batch)
    info["loss"] = float(full(metrics["loss"]))
    info["grad_norm"] = float(full(metrics["grad_norm"]))
    info["placements_kept"] = all(
        isinstance(p, DTensor) and isinstance(opt.master[n], DTensor)
        and tuple(p.placements) == spec_to_placements(pspecs[n], mesh)
        and tuple(opt.master[n].placements) == tuple(p.placements)
        for n, p in params.named_parameters())
    info["n_sharded"] = sum(any(isinstance(q, Shard) for q in p.placements)
                            for p in params.parameters())
    for n, p in params.named_parameters():
        out["p/" + n] = full(p.detach())
        out["m/" + n] = full(opt.master[n])

    # the expert-sharded einsum: 8 experts over "model" 4
    dcfg, dparams = model("deepseek-v2-lite-16b")
    ffn_plain = copy.deepcopy(dparams.blocks[0]["l0"].ffn)
    distribute_params(dparams, param_pspecs(dparams, dcfg, mesh), mesh)
    ffn = dparams.blocks[0]["l0"].ffn
    x = torch.from_numpy(inp["moe_x"])
    xd = put(x, ("data", None, None))
    with mesh_context(mesh):
        h = M.expert_hidden(ffn, xd)
        y = M.moe_forward(ffn, xd, dcfg.top_k)
    info["ep_local"] = list(h.to_local().shape)
    info["ep_global"] = list(h.shape)
    info["ep_placements"] = [str(q) for q in h.placements]
    out["ep"] = full(y).detach()
    with torch.no_grad():
        out["ep_scan"] = M.moe_forward(ffn_plain, x, dcfg.top_k)

    # qwen2-0.5b: 7 heads on "model" 4 -> the batch reshards around
    # attention over ("data", "model")
    qcfg, qparams = model("qwen2-0.5b")
    plain = copy.deepcopy(qparams)
    distribute_params(qparams, param_pspecs(qparams, qcfg, mesh), mesh)
    seen = []
    attn = T.gqa_attention

    def spy(p, h, *a, **k):
        seen.append(([str(q) for q in h.placements],
                     list(h.to_local().shape)))
        return attn(p, h, *a, **k)

    T.gqa_attention = spy
    toks = torch.from_numpy(inp["q_tokens"])
    with mesh_context(mesh), torch.no_grad():
        logits = T.forward(qparams, qcfg, put(toks, ("data", None)))
    T.gqa_attention = attn
    info["reshard"] = seen
    info["logits_placements"] = [str(q) for q in logits.placements]
    out["q_logits"] = full(logits)
    with torch.no_grad():
        out["q_logits_plain"] = T.forward(plain, qcfg, toks)

    # sharded decode: caches batch over "data", sequence over "model"
    cfg, params = model("internlm2-1.8b", "p/")
    plain = copy.deepcopy(params)
    distribute_params(params, param_pspecs(params, cfg, mesh), mesh)
    B, max_len = 4, 16
    cache = T.init_cache(cfg, B, max_len, device="cpu")
    specs = cache_pspecs(cache, cfg, mesh)
    dcache = {"blocks": {s: {k: put(t, specs["blocks"][s][k])
                             for k, t in c.items()}
                         for s, c in cache["blocks"].items()},
              "len": put(cache["len"], specs["len"])}
    info["cache_placements"] = [str(q) for q in
                                dcache["blocks"]["l0"]["k"].placements]
    pcache = T.init_cache(cfg, B, max_len, device="cpu")
    # every sharded attention goes through the decode kernel's wrapper, on
    # the rank's own slots, asking for the log-sum-exp it merges by
    from repro_torch.kernels import decode_attention as DA
    wrapper, calls = DA.decode_attention, []

    def counted(q, k, v, n, with_lse=False):
        calls.append((list(k.shape), with_lse))
        return wrapper(q, k, v, n, with_lse=with_lse)

    for i in range(6):
        tok = torch.from_numpy(inp["d_tokens"][i])
        DA.decode_attention = counted
        with mesh_context(mesh):
            dl, dcache = T.decode_step(params, cfg, put(tok, ("data", None)),
                                       dcache)
        DA.decode_attention = wrapper
        pl, pcache = T.decode_step(plain, cfg, tok, pcache)
        out[f"d_logits{i}"] = full(dl)
        out[f"d_logits_plain{i}"] = pl
    info["decode_calls"] = calls
    info["decode_layers"] = cfg.block_repeat * len(cfg.block_pattern)
    out["d_k"] = full(dcache["blocks"]["l0"]["k"])
    out["d_k_plain"] = pcache["blocks"]["l0"]["k"]

    if rank == 0:
        np.savez(f"{work}/out.npz",
                 **{k: v.detach().numpy() for k, v in out.items()})
    with open(f"{work}/info_{rank}.json", "w") as f:
        json.dump(info, f)
finally:
    dist.destroy_process_group()
'''


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
def run(tmp_path_factory):
    """The JAX single-device step and the port's single-rank step in this
    process; the sharded runs on 8 ranks."""
    work = str(tmp_path_factory.mktemp("sharded"))
    jcfg = dataclasses.replace(JC.get_reduced(ARCH), dtype="float32")
    tcfg = dataclasses.replace(TC.get_reduced(ARCH), dtype="float32")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    jstep = jax.jit(JS.make_train_step(jcfg, microbatches=1, remat=True))
    _, _, jm = jstep(jparams, JO.adamw_init(jparams),
                     {"tokens": jnp.asarray(toks),
                      "labels": jnp.asarray(labels)})

    params = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    inp = {"p/" + n: p.detach().numpy().copy()
           for n, p in params.named_parameters()}
    params, opt, tm = TS.make_train_step(tcfg, microbatches=1, remat=True)(
        params, TO.adamw_init(params),
        {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    inp.update(tokens=toks, labels=labels,
               moe_x=rng.standard_normal((4, 8, 64)).astype(np.float32),
               q_tokens=rng.integers(0, 512, (8, 12)).astype(np.int32),
               d_tokens=rng.integers(0, 512, (6, 4, 1)).astype(np.int32))
    assert TC.get_reduced("deepseek-v2-lite-16b").d_model == 64
    np.savez(os.path.join(work, "in.npz"), **inp)
    _run_ranks(work, WORLD)
    out = dict(np.load(os.path.join(work, "out.npz")))
    infos = []
    for r in range(WORLD):
        with open(os.path.join(work, f"info_{r}.json")) as f:
            infos.append(json.load(f))
    single = {"loss": float(tm["loss"]), "grad_norm": float(tm["grad_norm"]),
              "params": {n: p.detach().numpy()
                         for n, p in params.named_parameters()},
              "masters": {n: m.numpy() for n, m in opt.master.items()}}
    return dict(out=out, infos=infos, single=single,
                jax_loss=float(jm["loss"]))


def test_sharded_step_loss_and_grad_norm_equal_the_single_rank_step(run):
    for info in run["infos"]:
        assert abs(info["loss"] - run["single"]["loss"]) <= 1e-5
        np.testing.assert_allclose(info["grad_norm"],
                                   run["single"]["grad_norm"], rtol=1e-5)


def test_sharded_step_params_and_masters_equal_the_single_rank_step(run):
    for n, want in run["single"]["params"].items():
        np.testing.assert_allclose(run["out"]["p/" + n], want, rtol=0,
                                   atol=1e-6, err_msg=n)
        np.testing.assert_allclose(run["out"]["m/" + n],
                                   run["single"]["masters"][n], rtol=0,
                                   atol=1e-6, err_msg=n)


def test_sharded_step_keeps_the_placements(run):
    for info in run["infos"]:
        assert info["placements_kept"]
        assert info["n_sharded"] >= 10


def test_single_rank_loss_equals_jax(run):
    assert abs(run["single"]["loss"] - run["jax_loss"]) <= 1e-5


def test_expert_einsum_holds_a_share_of_the_experts_per_rank(run):
    for info in run["infos"]:
        # (E, B, S, f) = (8, 4, 8, 48): experts over "model" 4, batch
        # over "data" 2
        assert info["ep_global"] == [8, 4, 8, 48]
        assert info["ep_local"] == [2, 2, 8, 48]
        assert info["ep_placements"] == ["S(1)", "S(0)"]


def test_expert_einsum_equals_the_expert_loop(run):
    np.testing.assert_allclose(run["out"]["ep"], run["out"]["ep_scan"],
                               rtol=0, atol=1e-5)


def test_qwen2_batch_reshards_around_attention(run):
    for info in run["infos"]:
        # both layers: batch 8 over ("data", "model"), one row a rank
        assert info["reshard"] == [[["S(0)", "S(0)"], [1, 12, 56]]] * 2
        assert info["logits_placements"][0] == "S(0)"
    np.testing.assert_allclose(run["out"]["q_logits"],
                               run["out"]["q_logits_plain"], rtol=0,
                               atol=1e-5)


def test_sharded_decode_equals_the_single_rank_decode(run):
    for info in run["infos"]:
        assert info["cache_placements"] == ["S(1)", "S(2)"]
        # 6 steps x every layer, each on this rank's (B/2, Smax/4) slots
        assert info["decode_calls"] == \
            [[[2, 4, 2, 16], True]] * (6 * info["decode_layers"])
    for i in range(6):
        np.testing.assert_allclose(run["out"][f"d_logits{i}"],
                                   run["out"][f"d_logits_plain{i}"],
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(run["out"]["d_k"], run["out"]["d_k_plain"],
                               rtol=0, atol=1e-5)


def test_decode_lse_merges_disjoint_slot_ranges():
    """``decode_attention(..., with_lse=True)`` on CPU tensors: each row's
    log-sum-exp of its scaled scores over the valid slots (against
    float64 numpy), and the outputs over two halves of the cache merged
    by it equal the output over the whole (1e-6; what ``sp_decode``
    does across ranks).  Row 0's valid slots all lie in the first half:
    the second half's output for it gets no weight."""
    from repro_torch.kernels.decode_attention import decode_attention
    rng = np.random.default_rng(11)
    B, Hq, Hkv, D, S = 3, 4, 2, 16, 32
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    n = torch.tensor([5, 16, 29], dtype=torch.int32)
    whole, lse = decode_attention(q, k, v, n, with_lse=True)
    s = np.einsum("bgrd,bkgd->bgrk",
                  q.double().numpy().reshape(B, Hkv, Hq // Hkv, D),
                  k.double().numpy()).reshape(B, Hq, S) / np.sqrt(D)
    want = np.array([[np.log(np.exp(s[b, h, :int(n[b])]).sum())
                      for h in range(Hq)] for b in range(B)])
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)
    parts = [decode_attention(q, k[:, i:i + S // 2].contiguous(),
                              v[:, i:i + S // 2].contiguous(),
                              (n - i).clamp(0, S // 2).to(torch.int32),
                              with_lse=True) for i in (0, S // 2)]
    top = torch.maximum(parts[0][1], parts[1][1])
    w = [torch.exp(p[1] - top) for p in parts]
    merged = sum(p[0] * wi[..., None] for p, wi in zip(parts, w)) \
        / sum(w)[..., None]
    assert float(w[1][0].max()) == 0.0
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)


# -- MoE CHUNK_MAJOR ------------------------------------------------------------

def _moe(arch, seed=0):
    from repro_torch.layers import moe as TM
    cfg = dataclasses.replace(TC.get_reduced(arch), dtype="float32")
    gen = torch.Generator().manual_seed(seed)
    p = TM.init_moe(gen, cfg.d_model, cfg.d_ff_expert, cfg.n_routed,
                    cfg.top_k, cfg.n_shared, cfg.ffn_gated,
                    dtype=torch.float32)
    return cfg, p, TM


def _out_and_grads(TM, p, x, top_k):
    x = x.clone().requires_grad_(True)
    y = TM.moe_forward(p, x, top_k)
    leaves = [x] + list(p.parameters())
    grads = torch.autograd.grad((y * torch.cos(y)).sum(), leaves)
    return y.detach(), grads


@pytest.mark.parametrize("chunk", [4096, 24])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b"])
def test_chunk_major_equals_the_expert_loop(arch, chunk, monkeypatch):
    """Forward and gradients; chunks of 24 tokens leave the last of 50
    (B 2 x S 25) zero-padded.  fp32: outputs 1e-5, gradients 1e-5 plus
    rtol 1e-5 (the router's reach 30; read at most 1.1e-5 on those,
    a relative 3.9e-7)."""
    cfg, p, TM = _moe(arch)
    x = torch.randn(2, 25, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    want = _out_and_grads(TM, p, x, cfg.top_k)
    monkeypatch.setattr(TM, "CHUNK_MAJOR", True)
    monkeypatch.setattr(TM, "CHUNK_TOKENS", chunk)
    got = _out_and_grads(TM, p, x, cfg.top_k)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    for g, w in zip(got[1], want[1]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


JAX_CHUNK_MAJOR = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.layers import moe as M
M.CHUNK_MAJOR = True
inp = dict(np.load(sys.argv[1]))
params = {k[2:]: jnp.asarray(v) for k, v in inp.items() if k.startswith("p/")}
if any(k.startswith("s/") for k in inp):
    params["shared"] = {k[2:]: jnp.asarray(v) for k, v in inp.items()
                        if k.startswith("s/")}
y = M.moe_forward(params, jnp.asarray(inp["x"]), int(inp["top_k"]))
np.save(sys.argv[2], np.asarray(y))
'''


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b"])
def test_chunk_major_equals_jax_chunk_major(arch, tmp_path, monkeypatch):
    """4200 tokens: two chunks of 4096, the second zero-padded; the JAX
    layout in a subprocess with ``repro.layers.moe.CHUNK_MAJOR`` set
    (the module itself is not edited).  fp32 1e-4 (read at most
    4.8e-7)."""
    cfg, p, TM = _moe(arch)
    x = torch.randn(2, 2100, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    inp = {"x": x.numpy(), "top_k": np.array(cfg.top_k)}
    inp.update({"p/" + k: v.detach().numpy() for k, v in p.items()})
    if p.shared is not None:
        inp.update({"s/" + k: v.detach().numpy()
                    for k, v in p.shared.items()})
    np.savez(tmp_path / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", JAX_CHUNK_MAJOR,
                          str(tmp_path / "in.npz"), str(tmp_path / "y.npy")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    monkeypatch.setattr(TM, "CHUNK_MAJOR", True)
    with torch.no_grad():
        got = TM.moe_forward(p, x, cfg.top_k).numpy()
    np.testing.assert_allclose(got, np.load(tmp_path / "y.npy"), rtol=0,
                               atol=1e-4)
