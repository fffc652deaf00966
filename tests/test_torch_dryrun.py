"""The dry-run (``launch/dryrun_lib.py``, ``launch/dryrun.py``) against the
JAX package's: the HLO collective parsing and the traffic model with
``==`` on JAX's own inputs (``tests/test_dryrun.py``), ``DryrunCase`` and
``_spec_for`` field by field for every arch × shape,
``blockwise_attn_corr_flops``, the CLI's flags and defaults; the port's own
mechanism on ``meta`` tensors over a virtual mesh: the sharded engine's
all-reduces of a REDUCED train case against a count from its plan, a
step's FLOPs against the analytic count of the spec, the kernels reckoned
without a launch, the record's structural keys against JAX's
``lower_case`` on a debug mesh of four forced host devices (a subprocess),
and the FLOPs beside XLA's ``cost_analysis``.

The FLOPs band against XLA, [0.95, 1.0] of XLA's count: the port counts
the matmul-like products and the attention kernels' products over the
pairs their mask lets through; XLA also counts elementwise work (the
rest, under 5% at these shapes).  Where JAX's dense ``_sdpa`` runs
(Sq·Sk at most its blockwise threshold squared, train_4k) it computes
every score of the S × S block, masked ones too, so the port's attention
FLOPs are taken at S² pairs for that comparison; where JAX's blockwise
path runs (prefill_32k) its record's ``attn_corr_flops`` is added to
XLA's count, as the roofline does.  The band holds on a data-only mesh;
with model = 2 the ratio is printed (JAX shards the weights there, the
port's ranks hold copies).  Every case on ``meta`` takes seconds.
"""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import repro.configs as jconfigs
import repro.launch.dryrun_lib as JD
import repro_torch.configs as tconfigs
import repro_torch.launch.dryrun_lib as D
from repro_torch._tree import tree_leaves
from repro_torch.core import default_plan
from repro_torch.configs.shapes import SHAPES, sds
from repro_torch.kernels import swa_attention, tiered_aggregate
from repro_torch.launch import dryrun as cli
from repro_torch.models import SplittableModel
from repro_torch.optim import sgd

HERE = os.path.dirname(os.path.abspath(__file__))
BAND = (0.95, 1.0)

HLO_SAMPLE = """
  %all-reduce = f32[16,128]{1,0} all-reduce(%x), channel_id=1, replica_groups=[4,4]<=[16], use_global_device_ids=true, to_apply=%add
  %all-gather.1 = bf16[256,512]{1,0} all-gather(%y), channel_id=2, replica_groups=[2,8]<=[16], dimensions={0}
  %rs = f32[8,8]{1,0} reduce-scatter(%z), channel_id=3, replica_groups=[1,16]<=[16], to_apply=%add
  ROOT %all-to-all.2 = (f32[4,4]{1,0}, f32[4,4]{1,0}) all-to-all(%a, %b), replica_groups={{0,1,2,3}}
  %cp = u32[64]{0} collective-permute(%w), source_target_pairs={{0,1}}
  %not_a_collective = f32[2,2]{1,0} add(%p, %q)
"""


def _archs():
    return sorted(jconfigs.ARCH_IDS)


# --------------------------------------------------------------------------- #
# the verbatim parts
# --------------------------------------------------------------------------- #


def test_shape_bytes_equal_jax():
    for s in ("f32[16,128]{1,0}", "bf16[256,512]{1,0}", "(f32[4,4]{1,0}, f32[4,4]{1,0})",
              "pred[]", "s8[7,3]", "c64[2]", "u64[3,3]"):
        assert D._shape_bytes(s) == JD._shape_bytes(s), s


def test_parse_collectives_equals_jax():
    assert D.parse_collectives(HLO_SAMPLE) == JD.parse_collectives(HLO_SAMPLE)


def test_traffic_model_equals_jax():
    colls = [
        {"op": "all-reduce", "result_bytes": 100, "group": 4},
        {"op": "all-gather", "result_bytes": 100, "group": 4},
        {"op": "reduce-scatter", "result_bytes": 10, "group": 4},
        {"op": "all-to-all", "result_bytes": 7, "group": None},
        {"op": "collective-permute", "result_bytes": 5, "group": 2},
    ]
    assert D.collective_traffic_bytes(colls) == JD.collective_traffic_bytes(colls)
    assert D._summarize_collectives(colls) == JD._summarize_collectives(colls)
    assert D.COLLECTIVE_OPS == JD.COLLECTIVE_OPS
    assert D._DTYPE_BYTES == JD._DTYPE_BYTES
    assert D.QUADRATIC_FAMILIES == JD.QUADRATIC_FAMILIES


def test_dryrun_case_fields_and_defaults_equal_jax():
    tf, jf = dataclasses.fields(D.DryrunCase), dataclasses.fields(JD.DryrunCase)
    assert [(f.name, f.default) for f in tf] == [(f.name, f.default) for f in jf]
    for mp in (False, True):
        for unroll in (None, True, False):
            assert (D.DryrunCase("a", "b", mp, unroll=unroll).resolved_unroll
                    == JD.DryrunCase("a", "b", mp, unroll=unroll).resolved_unroll)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_spec_for_equals_jax_for_every_arch(shape):
    for arch in _archs():
        for kw in ({}, dict(remat=False), dict(remat_policy="dots"), dict(dtype="bfloat16")):
            ts, tsh = D._spec_for(D.DryrunCase(arch, shape, False, **kw))
            js, jsh = JD._spec_for(JD.DryrunCase(arch, shape, False, **kw))
            assert dataclasses.asdict(ts) == dataclasses.asdict(js), (arch, shape, kw)
            assert dataclasses.asdict(tsh) == dataclasses.asdict(jsh)


def test_blockwise_correction_equals_jax():
    for arch in _archs():
        for shape in sorted(SHAPES):
            ts, tsh = D._spec_for(D.DryrunCase(arch, shape, False))
            js, jsh = JD._spec_for(JD.DryrunCase(arch, shape, False))
            for n in (4, 256, 512):
                assert (D.blockwise_attn_corr_flops(ts, tsh, n)
                        == JD.blockwise_attn_corr_flops(js, jsh, n)), (arch, shape, n)


def test_save_result_names_the_file_as_jax(tmp_path):
    meta = {"arch": "a/b", "shape": "train_4k", "mesh": "16x16", "tag": "t", "flops": 1.0}
    p = D.save_result(meta, str(tmp_path / "port"))
    q = JD.save_result(meta, str(tmp_path / "jax"))
    assert os.path.basename(p) == os.path.basename(q)
    assert json.load(open(p)) == json.load(open(q))


def _jax_parser(monkeypatch):
    """JAX's CLI parser, caught as its ``main`` parses (its import sets
    XLA_FLAGS, which the monkeypatch restores)."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    import repro.launch.dryrun as jcli

    caught = {}

    class Caught(Exception):
        pass

    def grab(self, args=None, namespace=None):
        caught["parser"] = self
        raise Caught

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Caught):
        jcli.main([])
    monkeypatch.undo()
    return caught["parser"]


def _actions(parser):
    return sorted((tuple(a.option_strings), a.dest, a.default, tuple(a.choices or ()),
                   a.required, type(a).__name__) for a in parser._actions
                  if a.dest != "help")


def test_cli_flags_and_defaults_equal_jax(monkeypatch):
    jp = _jax_parser(monkeypatch)
    caught = {}

    def grab(self, args=None, namespace=None):
        caught["parser"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        cli.parse_args([])
    assert _actions(caught["parser"]) == _actions(jp)


@pytest.mark.parametrize("flag,shape", [("--seq-shard", "train_4k"),
                                        ("--cache-seq-shard", "decode_32k"),
                                        ("--moe-shard", "decode_32k")])
def test_gspmd_flags_raise(flag, shape, tmp_path):
    with pytest.raises(NotImplementedError, match="GSPMD"):
        cli.main(["--arch", "smollm-135m", "--shape", shape, flag, "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())


# --------------------------------------------------------------------------- #
# the port's mechanism on meta tensors
# --------------------------------------------------------------------------- #


@pytest.fixture
def reduced(monkeypatch):
    """Cases on the REDUCED configs (``_spec_for`` reads ``get_spec``)."""
    monkeypatch.setattr(D, "get_spec", tconfigs.get_reduced)


def test_reduced_train_case_records_the_plan_s_all_reduces(reduced):
    """data = 2, model = 1: two clients, one a rank, plan cuts (1, 1),
    entities (2, 1, 1).  Round 0 runs tier 3's entity and fed levels, each
    spanning both ranks: two all-reduces of the tier's parameters (unit 1
    and the head) in f32; tier 1's entity level is device-local and tier 2
    holds no unit.  One all-gather of the two clients' losses."""
    mesh = D.VirtualMesh((2, 1), ("data", "model"))
    rec = D.run_case(D.DryrunCase("smollm-135m", "train_4k", False), mesh)
    spec = tconfigs.get_reduced("smollm-135m")
    assert rec["plan"] == {"cuts": (1, 1), "intervals": (8, 4, 1), "entities": (2, 1, 1),
                           "num_clients": 2}
    p = D.meta_params(SplittableModel(spec))
    top = sum(x[1:].numel() for x in tree_leaves(p["units"])) + sum(
        x.numel() for x in tree_leaves(p["head"]))
    colls = [{"op": "all-reduce", "result_bytes": 4 * top, "group": 2}] * 2 + [
        {"op": "all-gather", "result_bytes": 4 * 2, "group": 2}]
    assert rec["collectives"] == D._summarize_collectives(colls)
    assert rec["collective_bytes"] == D.collective_traffic_bytes(colls)
    assert rec["collective_bytes"] == 2 * 2 * 4 * top / 2 + 8 / 2
    assert rec["unrolled"] is True and rec["alias_bytes"] == 0


@pytest.mark.parametrize("opt,moments", [("momentum", 1), ("adam", 2)])
def test_train_case_holds_the_named_optimizer_s_state(reduced, opt, moments):
    """``--opt`` picks the step's optimizer: its moments are held beside the
    params (adam also its int32 step counter).  JAX's lowering fails there:
    it steps SGD and lays out the moments' specs (ROADMAP §C)."""
    mesh = D.VirtualMesh((2, 1), ("data", "model"))
    base = D.run_case(D.DryrunCase("smollm-135m", "train_4k", False), mesh)
    rec = D.run_case(D.DryrunCase("smollm-135m", "train_4k", False, opt_name=opt), mesh)
    params = sum(x.numel() * 4 for x in tree_leaves(
        D.meta_params(SplittableModel(tconfigs.get_reduced("smollm-135m")))))
    assert rec["arg_bytes"] - base["arg_bytes"] == moments * params + 4 * (opt == "adam")


def test_no_model_axis_collective_and_serving_issues_none(reduced):
    mesh = D.VirtualMesh((2, 2), ("data", "model"))
    rec = D.run_case(D.DryrunCase("smollm-135m", "train_4k", False), mesh)
    assert set(rec["collectives"]) == {"all-reduce", "all-gather"}
    assert "model" in rec["model_axis"]
    for shape in ("prefill_32k", "decode_32k"):
        rec = D.run_case(D.DryrunCase("smollm-135m", shape, False), mesh)
        assert rec["collectives"] == {} and rec["collective_bytes"] == 0.0


def _lm_forward_flops(spec, sequences, seq):
    d, ff, hd, h, kv = spec.d_model, spec.d_ff, spec.hd, spec.num_heads, spec.num_kv_heads
    tokens = sequences * seq
    units = spec.n_units * (2.0 * tokens * (d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff)
                            + 4.0 * hd * h * sequences * seq * (seq + 1) / 2)
    return units, 2.0 * tokens * d * spec.padded_vocab


@pytest.mark.parametrize("policy", [None, "full", "dots"])
def test_train_step_flops_equal_the_analytic_count(policy):
    """One unsharded Engine A step of smollm-135m at full width (N = 4,
    batch 1, S = 256): forward, backward twice the forward, the units'
    forward once more under ``"full"`` remat; ``"dots"`` recomputes the
    attention kernels only.  Within 1%."""
    spec = tconfigs.get_spec("smollm-135m")
    if policy:
        spec = dataclasses.replace(spec, remat=True, remat_policy=policy)
    model = SplittableModel(spec)
    N, S = 4, 256
    plan = default_plan(spec.n_units, N, cuts=(6, 15))
    batch = {k: sds((N, 1, S), torch.int32) for k in ("tokens", "labels")}
    got = D.count_train_step(model, plan, sgd(1e-3), batch)
    units, head = _lm_forward_flops(spec, N, S)
    want = 3 * (units + head) + {None: 0.0, "full": units,
                                 "dots": units - spec.n_units * 2.0 * N * S * (
                                     spec.d_model * spec.num_heads * spec.hd * 2
                                     + 2 * spec.d_model * spec.num_kv_heads * spec.hd
                                     + 3 * spec.d_model * spec.d_ff)}[policy]
    assert abs(got["flops"] / want - 1) < 0.01, (got["flops"], want)
    assert got["kernels"]["swa_attention_fwd"]["calls"] == spec.n_units * (2 if policy else 1)
    assert got["kernels"]["swa_attention_bwd_dq"]["calls"] == spec.n_units
    assert got["arg_bytes"] == sum(x.numel() * 4 for x in tree_leaves(
        D.meta_params(model))) * N + 2 * N * S * 4


def test_meta_calls_launch_nothing_and_tell_the_recorder():
    """The kernel wrappers on ``meta`` tensors return empty outputs of the
    kernels' shapes, count no launch and tell the active recorder."""
    swa_attention.reset_launches()
    tiered_aggregate.reset_launches()
    seen = []
    from repro_torch.kernels import meta

    q, k = sds((2, 8, 4, 32), torch.float32), sds((2, 8, 2, 32), torch.float32)
    x, w = sds((4, 100), torch.float32), sds((4,), torch.float32)
    with meta.recording(lambda name, shape: seen.append(name)):
        o, lse = swa_attention.swa_attention_fwd(q, k, k, 0, 0)
        dq, delta = swa_attention.swa_attention_bwd_dq(q, k, k, o, lse, o, 4, 0)
        dk, dv = swa_attention.swa_attention_bwd_dkv(q, k, k, lse, delta, o)
        od = swa_attention.swa_decode(sds((2, 1, 4, 32), torch.float32), k, k,
                                      sds((8,), torch.int32), sds((1,), torch.int32))
        y = tiered_aggregate.tiered_aggregate(x, w, 1, 1, 2)
    assert seen == ["swa_attention_fwd", "swa_attention_bwd_dq", "swa_attention_bwd_dkv",
                    "swa_decode", "tiered_aggregate"]
    assert o.shape == q.shape and lse.shape == (2, 4, 8) and dk.shape == k.shape
    assert od.shape == (2, 1, 4, 32) and y.shape == x.shape and y.device.type == "meta"
    assert not any(swa_attention.launches.values())
    assert not any(swa_attention.decode_launches.values())
    assert not any(tiered_aggregate.launches.values())


def test_attention_pairs_count_the_kernels_mask():
    """Against a brute-force count of the mask: causal, windowed, prefix,
    Sq != Sk (cross-attention: every key) and the encoder (a prefix of S)."""
    for Sq, Sk, W, P in [(7, 7, 0, 0), (9, 9, 3, 0), (9, 9, 0, 4), (9, 9, 3, 5),
                         (5, 12, 0, 12), (12, 5, 0, 5), (6, 6, 0, 6)]:
        brute = sum(1 for p in range(Sq) for j in range(Sk)
                    if (j <= p or j < P) and (W == 0 or j > p - W))
        assert D.attention_pairs(Sq, Sk, W, P) == brute, (Sq, Sk, W, P)
    assert D.visible_pairs(1024, 0) == 1024 * 1025 // 2
    assert D.visible_pairs(1024, 4096) == D.visible_pairs(1024, 0)


# --------------------------------------------------------------------------- #
# against JAX's lower_case on a debug mesh
# --------------------------------------------------------------------------- #

JAX_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import repro.configs as jc
    import repro.launch.dryrun_lib as JD
    from repro.launch.mesh import make_debug_mesh

    JD.get_spec = jc.get_reduced
    out = {}
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        for model in (1, 2):
            mesh = make_debug_mesh(data=2, model=model)
            lowered, meta = JD.lower_case(JD.DryrunCase("smollm-135m", shape, False), mesh)
            ca = lowered.compile().cost_analysis()
            if isinstance(ca, (list, tuple)):
                ca = ca[0]
            meta["flops"] = float(ca.get("flops", 0.0))
            meta["attn_corr_flops"] = JD.blockwise_attn_corr_flops(
                *JD._spec_for(JD.DryrunCase("smollm-135m", shape, False)), meta["num_devices"])
            out[f"{shape}/{model}"] = meta
    print("JAX-DRYRUN " + json.dumps(out, default=str))
""")

STRUCTURAL = ("arch", "shape", "mesh", "axes", "kind", "tag", "window", "dtype", "num_devices",
              "round_kind", "plan", "global_batch", "seq_len")


@pytest.fixture(scope="module")
def jax_records():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(HERE, "..", "src"), HERE])
    env["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run([sys.executable, "-c", JAX_SCRIPT], env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    line = next(x for x in run.stdout.splitlines() if x.startswith("JAX-DRYRUN "))
    return json.loads(line[len("JAX-DRYRUN "):])


@pytest.mark.parametrize("model_axis", [1, 2])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_structural_keys_equal_jax_and_flops_in_band(jax_records, shape, model_axis,
                                                     monkeypatch):
    monkeypatch.setattr(D, "get_spec", tconfigs.get_reduced)
    rec = D.run_case(D.DryrunCase("smollm-135m", shape, False),
                     D.VirtualMesh((2, model_axis), ("data", "model")))
    ref = jax_records[f"{shape}/{model_axis}"]
    got = json.loads(json.dumps({k: rec[k] for k in STRUCTURAL if k in rec}, default=str))
    assert got == {k: ref[k] for k in STRUCTURAL if k in ref}
    assert set(rec) >= set(ref) - {"compile_s", "hlo_bytes"}
    # held on the data-only mesh, where a rank of either package does its
    # clients' whole step; with model = 2 JAX shards the weights over
    # `model` and its per-device count depends on which of XLA's
    # partitioned ops stay replicated at REDUCED widths: printed only
    xla = ref["flops"] + ref["attn_corr_flops"]
    port = rec["flops"]
    spec, sh_ = D._spec_for(D.DryrunCase("smollm-135m", shape, False))
    if sh_.kind == "train" and sh_.seq_len ** 2 <= D.BLOCKWISE_THRESHOLD ** 2:
        S = sh_.seq_len
        port += rec["kernel_flops"] * (S * S / D.visible_pairs(S, spec.window) - 1)
    ratio = port / xla
    print(f"{shape} model={model_axis}: port {rec['flops']:.6g} (dense-equivalent "
          f"{port:.6g}) against XLA {xla:.6g}: {ratio:.4f}")
    if model_axis == 1:
        assert BAND[0] <= ratio <= BAND[1], ratio
