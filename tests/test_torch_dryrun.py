"""The port's dry-run (``repro_torch.launch.{shapes,op_counts,dryrun}``)
against the live reference (``repro.launch.dryrun``), on the CPU.

Both run in subprocesses, side by side, on REDUCED configs and small
cells (seq 64 x batch 8): the reference lowers and compiles each cell
for 8 host devices (``XLA_FLAGS``) on a (1, 1) and a (2, 4) ("data",
"model") mesh; the port traces it on a fake process group of 8 ranks
with meta DTensors on meshes of the same shapes.

What is held, and to what:
  * (1, 1), prefill and decode: ``dot_flops`` exactly (one device runs
    every product of the cell in both packages), for every arch whose
    cell the reference lowers, except the SSD prefills;
  * the SSD prefills (mamba2, zamba2) on (1, 1): the port's count within
    [1, 1.06] of the reference's (read 1.053 and 1.033): the chunked scan
    of the port's plain version forms its intra-chunk products over
    whole (Q, Q) blocks where the reference's contracts part of them
    first;
  * train on (1, 1): within [1, 1.10] (read 1.041-1.078): the port
    checkpoints each loss chunk's logits and computes them again in the
    backward pass (one more head product, 2 B S d V), and its
    checkpointed blocks rerun the flash forward where XLA drops part of
    the reference's recomputation;
  * (2, 4): the port's per-rank count, as a multiple of 1/8 of the
    whole cell's, within 1% of the multiple read for that cell
    (``PER_RANK``, 1.000-1.729).  DTensor keeps the batch sharded over
    "data" and the heads, the d_ff columns or the experts over "model";
    the multiple is above 1 by the products whose operands a rank holds
    whole on "model" (read, not derived per product).  A step that
    sharded nothing
    would read 8, and every cell is also held below 4.  XLA gathers the
    tokens and computes every row on every device here (its partitioned
    HLO's products are (B S, ...) = (512, ...)), so the reference's
    count is 4.6-8x the port's and is only printed;
  * ``argument_bytes`` equal to XLA's ``argument_size_in_bytes`` on every
    cell of both meshes (the two packages' sharding rules agree);
  * ``_analytic_workspace`` equal to the reference's for every arch x
    shape x production mesh x microbatch count;
  * ``collective_bytes`` by kind is printed beside the reference's, not
    held: DTensor and XLA's partitioner choose different collectives.

The reference cannot lower qwen2-vl-7b on this JAX (``jnp.repeat`` asks
for an ``out_sharding`` under the mesh), so no qwen2-vl cell is compared.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from conftest import REPO  # noqa: E402

SUB_TIMEOUT = 400
MESHES = ((1, 1), (2, 4))
FAST = {  # arch -> kinds traced on both meshes
    "internlm2_1_8b": ("prefill", "decode"),
    "qwen2_0_5b": ("prefill", "decode"),
    "qwen1_5_32b": ("prefill", "decode"),
    "gemma3_12b": ("prefill", "decode"),
    "deepseek_v2_lite_16b": ("prefill", "decode"),
    "mixtral_8x7b": ("prefill", "decode"),
    "seamless_m4t_large_v2": ("prefill", "decode"),
    "mamba2_2_7b": ("prefill", "decode"),
    "zamba2_7b": ("prefill", "decode"),
}
TRAIN = {  # arch -> meshes of its train cell
    "internlm2_1_8b": MESHES,
    "qwen2_0_5b": ((2, 4),),
    "deepseek_v2_lite_16b": MESHES,
}
SSD_ARCHS = ("mamba2_2_7b", "zamba2_7b")
CELLS = [(a, k, m) for a, ks in FAST.items() for k in ks for m in MESHES] \
    + [(a, "train", m) for a, ms in TRAIN.items() for m in ms]

COMMON = r'''
import json, os
CELLS = json.loads(os.environ["DRYRUN_CELLS"])
'''

REF = COMMON + r'''
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.devices()   # 8 host devices, before the dry-run module sets its flag
from repro import configs as C
from repro.launch import dryrun as D
from repro.launch.shapes import SHAPES, ShapeCell
for kind in ("train", "prefill", "decode"):
    SHAPES[kind] = ShapeCell(kind, 64, 8, kind)
out = {"cells": {}, "workspace": {}}
meshes = {}
for arch, kind, shape in CELLS:
    shape = tuple(shape)
    if shape not in meshes:
        n = shape[0] * shape[1]
        meshes[shape] = jax.make_mesh(shape, ("data", "model"),
                                      devices=jax.devices()[:n])
    r = D.lower_cell(arch, kind, meshes[shape],
                     cfg_override=C.get_reduced(arch))
    out["cells"][f"{arch}|{kind}|{shape[0]}x{shape[1]}"] = {
        "dot_flops": r["dot_flops"],
        "argument_bytes": r["memory"]["argument_size_in_bytes"],
        "collective_bytes": r["collective_bytes"]}

class Mesh:   # _analytic_workspace reads mesh.shape only
    def __init__(self, shape):
        self.shape = shape
for axes in ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}):
    for arch in C.ARCHS:
        for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            for mb in (1, 4):
                key = f"{arch}|{name}|{'x'.join(map(str, axes.values()))}|{mb}"
                out["workspace"][key] = D._analytic_workspace(
                    C.get_config(arch), SHAPES[name], Mesh(axes), mb)
out["skips"] = {a: C.shape_skips(a) for a in C.ARCHS}
print("RESULT" + json.dumps(out))
'''

PORT = COMMON + r'''
from repro_torch import configs as C
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shapes import SHAPES, ShapeCell
D.init_fake_group(8)
out = {"cells": {}, "workspace": {}}
meshes = {}
for arch, kind, shape in CELLS:
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = make_mesh(shape, ("data", "model"), device="cpu")
    r = D.lower_cell(arch, kind, meshes[shape],
                     cfg_override=C.get_reduced(arch),
                     cell=ShapeCell(kind, 64, 8, kind), device_bytes=80e9)
    out["cells"][f"{arch}|{kind}|{shape[0]}x{shape[1]}"] = {
        k: r[k] for k in ("dot_flops", "argument_bytes", "collective_bytes",
                          "status")}
for axes in ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}):
    for arch in C.ARCHS:
        for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            for mb in (1, 4):
                key = f"{arch}|{name}|{'x'.join(map(str, axes.values()))}|{mb}"
                out["workspace"][key] = D._analytic_workspace(
                    C.get_config(arch), SHAPES[name], axes, mb)
out["skips"] = {a: C.shape_skips(a) for a in C.ARCHS}
# one product on the (2, 4) mesh, rows over "data": OpCounter counts the
# rank's half, FlopCounterMode the whole product
import torch
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.placement_types import Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch import op_counts
mesh = meshes[(2, 4)]
a = distribute_tensor(torch.ones(256, 64), mesh, [Shard(0), Replicate()])
b = distribute_tensor(torch.ones(64, 32), mesh, [Replicate(), Replicate()])
_, mine = op_counts.count(torch.matmul, a, b)
with FlopCounterMode(display=False) as fc:
    torch.matmul(a, b)
out["one_product"] = [mine["dot_flops"], fc.get_total_flops()]
print("RESULT" + json.dumps(out))
'''


def _start(code: str, env: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc: subprocess.Popen, what: str) -> dict:
    try:
        out, err = proc.communicate(timeout=SUB_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what} ran past {SUB_TIMEOUT} s")
    assert proc.returncode == 0, f"{what} failed:\n{err[-4000:]}"
    return json.loads(out.split("RESULT", 1)[1])


@pytest.fixture(scope="module")
def runs():
    """The reference's and the port's records of every cell, computed in
    two subprocesses at once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", DRYRUN_CELLS=json.dumps(CELLS))
    ref = _start(REF, env)
    port = _start(PORT, env)
    return {"ref": _result(ref, "the reference's dry-run"),
            "port": _result(port, "the port's dry-run")}


def _key(arch, kind, mesh):
    return f"{arch}|{kind}|{mesh[0]}x{mesh[1]}"


def test_shape_skips_match_the_reference(runs):
    assert runs["port"]["skips"] == runs["ref"]["skips"]


def test_op_counter_counts_one_ranks_share(runs):
    """(256, 64) x (64, 32) with the rows over "data" 2: one rank's local
    product is half the FLOPs ``FlopCounterMode`` counts on the
    DTensors."""
    mine, whole = runs["port"]["one_product"]
    assert whole == 2 * 256 * 64 * 32
    assert mine == whole / 2


def test_analytic_workspace_matches_exactly(runs):
    ref, port = runs["ref"]["workspace"], runs["port"]["workspace"]
    assert len(port) == 2 * 10 * 4 * 2
    assert port == ref


EXACT = [(a, k) for a, ks in FAST.items() for k in ks
         if not (k == "prefill" and a in SSD_ARCHS)]


@pytest.mark.parametrize("arch,kind", EXACT)
def test_dot_flops_exact_on_one_device(runs, arch, kind):
    key = _key(arch, kind, (1, 1))
    assert runs["port"]["cells"][key]["status"] == "ok"
    assert runs["port"]["cells"][key]["dot_flops"] \
        == runs["ref"]["cells"][key]["dot_flops"]


@pytest.mark.parametrize("arch,kind,lo,hi", [
    ("mamba2_2_7b", "prefill", 1.0, 1.06),
    ("zamba2_7b", "prefill", 1.0, 1.06),
    ("internlm2_1_8b", "train", 1.0, 1.10),
    ("deepseek_v2_lite_16b", "train", 1.0, 1.10)])
def test_dot_flops_close_on_one_device(runs, arch, kind, lo, hi):
    key = _key(arch, kind, (1, 1))
    ratio = (runs["port"]["cells"][key]["dot_flops"]
             / runs["ref"]["cells"][key]["dot_flops"])
    print(f"{key}: port / reference dot_flops = {ratio:.4f}")
    assert lo <= ratio <= hi


# (arch, kind) -> the port's per-rank dot FLOPs on (2, 4) over 1/8 of the
# whole cell's (the port's own (1, 1) count; the reference's (2, 4) count
# for qwen2's train cell, which is traced on (2, 4) only), as read
PER_RANK = {
    ("internlm2_1_8b", "prefill"): 1.640,
    ("internlm2_1_8b", "decode"): 1.167,
    ("qwen2_0_5b", "prefill"): 1.000,
    ("qwen2_0_5b", "decode"): 1.429,
    ("qwen1_5_32b", "prefill"): 1.000,
    ("qwen1_5_32b", "decode"): 1.652,
    ("gemma3_12b", "prefill"): 1.567,
    ("gemma3_12b", "decode"): 1.235,
    ("deepseek_v2_lite_16b", "prefill"): 1.102,
    ("deepseek_v2_lite_16b", "decode"): 1.025,
    ("mixtral_8x7b", "prefill"): 1.397,
    ("mixtral_8x7b", "decode"): 1.122,
    ("seamless_m4t_large_v2", "prefill"): 1.000,
    ("seamless_m4t_large_v2", "decode"): 1.000,
    ("mamba2_2_7b", "prefill"): 1.247,
    ("mamba2_2_7b", "decode"): 1.173,
    ("zamba2_7b", "prefill"): 1.154,
    ("zamba2_7b", "decode"): 1.112,
    ("internlm2_1_8b", "train"): 1.430,
    ("qwen2_0_5b", "train"): 1.729,
    ("deepseek_v2_lite_16b", "train"): 1.046,
}


@pytest.mark.parametrize("cell", [c for c in CELLS if c[2] == (2, 4)],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_dot_flops_per_rank_on_the_mesh(runs, cell):
    arch, kind, mesh = cell
    port = runs["port"]["cells"][_key(arch, kind, mesh)]
    ref = runs["ref"]["cells"][_key(arch, kind, mesh)]
    assert port["status"] == "ok"
    whole = runs["port"]["cells"].get(_key(arch, kind, (1, 1)), ref)
    share = port["dot_flops"] / (whole["dot_flops"] / 8)
    print(f"{arch} {kind} 2x4: port {port['dot_flops']:.4e} reference "
          f"{ref['dot_flops']:.4e} whole cell {whole['dot_flops']:.4e}: "
          f"{share:.4f} x whole / 8")
    assert share == pytest.approx(PER_RANK[arch, kind], rel=0.01)
    assert share < 4


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}-"
                         f"{c[2][0]}x{c[2][1]}")
def test_argument_bytes_match_xla(runs, cell):
    key = _key(*cell)
    assert runs["port"]["cells"][key]["argument_bytes"] \
        == runs["ref"]["cells"][key]["argument_bytes"]


def test_collective_bytes_printed_beside_the_reference(runs):
    """Not held: the ratios by kind go to PERF.md."""
    for arch, kind, mesh in CELLS:
        if mesh != (2, 4):
            continue
        key = _key(arch, kind, mesh)
        p = runs["port"]["cells"][key]["collective_bytes"]
        r = runs["ref"]["cells"][key]["collective_bytes"]
        kinds = sorted(set(p) | set(r))
        print(key, {k: (p.get(k, 0.0), r.get(k, 0.0)) for k in kinds})
        assert set(p) <= {"all-reduce", "all-gather", "reduce-scatter",
                          "all-to-all", "collective-permute"}
        assert sum(p.values()) > 0


def _cli(args, tmp_path, code=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cmd = [sys.executable, "-c", code] if code else \
        [sys.executable, "-m", "repro_torch.launch.dryrun"]
    return subprocess.run(cmd + args, env=env, capture_output=True,
                          text=True, timeout=SUB_TIMEOUT, cwd=tmp_path)


def test_cli_runs_a_production_mesh_cell(tmp_path):
    out = tmp_path / "dry.json"
    res = _cli(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                "--device-bytes", "80e9", "--out", str(out)], tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert rec["mesh"] == "16x16" and rec["kind"] == "decode"
    assert rec["dot_flops"] > 0 and rec["collective_bytes"]
    assert rec["per_device_bytes"] == rec["argument_bytes"] \
        + rec["workspace_model"]
    assert rec["fits"] is True


def test_cli_needs_device_bytes_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card gives the device bytes")
    res = _cli(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                "--out", str(tmp_path / "x.json")], tmp_path)
    assert res.returncode != 0 and "--device-bytes" in res.stderr


BAD_SPECS = r'''
import sys
from repro_torch.launch import dryrun as D
def bad(params, cfg, mesh, fsdp=False):
    # every parameter sharded along a dim it does not have
    return {n: (None,) * p.dim() + ("model",)
            for n, p in params.named_parameters()}
D.param_pspecs = bad
sys.exit(D.main())
'''


def test_cli_fails_on_a_cell_whose_specs_disagree(tmp_path):
    out = tmp_path / "dry.json"
    res = _cli(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                "--device-bytes", "80e9", "--out", str(out)], tmp_path,
               code=BAD_SPECS)
    assert res.returncode != 0
    (rec,) = json.loads(out.read_text())
    assert rec["status"].startswith("error:")
