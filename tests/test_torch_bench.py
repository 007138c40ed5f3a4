"""The port's benchmark entry points on the CPU: the stylize program of
``vst_torch.bench`` against vst's FastStyleNet run as ``bench.py:_measure``
runs it (params cast to the config's dtype), the JSON line's keys against
``bench.py``'s, and ``vst_torch.cli bench-raft`` at a tiny size.

Weights: vst's init from PRNGKey(0) with the output head's kernel × 300, so
the [0, 1] output spreads (std ≈ 0.21) instead of sitting at 0.5; carried
into the port with ``faststyle_state_dict_from_jax``. Tolerances on the
clamped output, measured on a CPU: float32 1e-4 (measured 7.7e-6); bfloat16
max |Δ| ≤ 0.06 and mean |Δ| ≤ 0.012 (measured 0.029 and 0.0058: the two
frameworks round convolutions, norms and the head to bf16 at different
points).
"""

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torch_train_parity import torch_threads  # noqa: F401 (autouse)
from vst.models.faststyle import FastStyleNet as JFastStyleNet
from vst_torch import bench
from vst_torch.cli.__main__ import main as cli_main
from vst_torch.cli.__main__ import parser
from vst_torch.convert import faststyle_state_dict_from_jax
from vst_torch.models.faststyle import FastStyleNet
from vst_torch.ops import image

ROOT = Path(__file__).resolve().parents[1]


def _jax_params():
    params = JFastStyleNet(n_styles=3).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 48, 3)),
                                            1.0, 0)["params"]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    head = params["ConvTanh_0"]["ConvLayer_0"]["TorchConv_0"]["Conv_0"]
    head["kernel"] = head["kernel"] * 300.0
    return params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stylize_matches_vst(dtype):
    x = np.random.RandomState(0).rand(2, 32, 48, 3).astype(np.float32)
    params = _jax_params()
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    cast = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdtype), params)  # bench.py:28
    _, out = JFastStyleNet(n_styles=3).apply({"params": cast}, jnp.asarray(x).astype(jdtype),
                                             1.0, 0)
    want = np.asarray(jnp.clip(out / 255.0, 0.0, 1.0).astype(jnp.float32))

    net = FastStyleNet(n_styles=3)
    net.load_state_dict(faststyle_state_dict_from_jax(params), strict=True)
    net = net.to(tdtype).eval()
    stylize = bench.make_stylize(net, torch.zeros((), dtype=torch.long))
    with torch.no_grad():
        got = stylize(torch.from_numpy(x).permute(0, 3, 1, 2).to(tdtype))
    assert got.dtype == tdtype and got.shape == (2, 3, 32, 48)
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert want.std() > 0.1
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - want).max() <= 0.06
        assert np.abs(got - want).mean() <= 0.012


def _bench_py_configs():
    """(name, donate) of every config in bench.py's main."""
    src = (ROOT / "bench.py").read_text()
    return [(m.group(1), bool(m.group(2))) for m in
            re.finditer(r'\("(\w+)", jnp\.\w+, \d+, "natural"(, True)?\)', src)]


def _bench_py_keys():
    """The keys of the dict bench.py's main prints (``out = {...}``)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "out" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("bench.py's out dict not found")


def test_configs_are_bench_py_without_donation():
    configs = _bench_py_configs()
    assert len(configs) == 9
    assert [name for name, _, _ in bench.CONFIGS] == [n for n, donate in configs if not donate]
    # the _dn configs measure XLA buffer donation, which PyTorch has not
    assert all(n.endswith("_dn") for n, donate in configs if donate)


def test_report_has_bench_py_keys():
    fake = {name: {"fps": 100.0 * (i + 1), "ms": 10.0 / (i + 1), "ms_mean": 11.0 / (i + 1),
                   "ms_fused": 9.0 / (i + 1), "peak_mem_gib": 0.5 * (i + 1)}
            for i, (name, _, _) in enumerate(bench.CONFIGS)}
    line = bench.report(fake, "a card")
    assert _bench_py_keys() <= set(line)
    assert line["best_config"] == "bf16_b128" and line["value"] == 600.0
    assert line["vs_baseline"] == pytest.approx(600.0 * 5.87 / 1000.0)
    assert line["latency_ms_f32_b1"] == 10.0 and line["device"] == "a card"
    assert set(line["paths_ms"]) == set(line["paths_ms_fused"]) == set(fake)
    assert not any(k.endswith("_dn") for k in line["paths_ms"])
    json.dumps(line, allow_nan=False)


def test_bench_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(device="cpu")


def test_bench_raft_arguments():
    args = parser().parse_args(["bench-raft"])
    assert (tuple(args.hw), args.raft_iters, args.iters, args.device) == ((436, 1024), 20, 5, "cuda")
    # vst/cli/__main__.py:1067-1071, in vst's order
    assert args.variants == ["f32", "bf16_enc", "bf16_full", "f32_pad64", "bf16_full_pad64"]
    args = parser().parse_args(["bench-raft", "--variants", "f32", "--hw", "64", "96"])
    assert args.variants == ["f32"] and args.hw == [64, 96]
    with pytest.raises(SystemExit):
        parser().parse_args(["bench-raft", "--variants", "bf16_pad64"])


def test_bench_raft_on_cpu_writes_its_keys(tmp_path, capsys):
    cli_main(["bench-raft", "--device", "cpu", "--hw", "64", "64", "--raft-iters", "2",
              "--iters", "1", "--out-dir", str(tmp_path)])
    with open(tmp_path / "raft_timing.json") as f:
        res = json.load(f)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    # vst/cli/__main__.py:cmd_bench_raft's keys: every variant, the slopes of
    # f32 and bf16_full_pad64, each variant's flow against f32's
    others = ("bf16_enc", "bf16_full", "f32_pad64", "bf16_full_pad64")
    assert set(res) == {"hw", "iters", "device", "methodology", "weights", "pair_ms_f32",
                        "pair_ms_f32_x2", "pair_ms_f32_x4", "pair_ms_bf16_full_pad64_x2",
                        "pair_ms_bf16_full_pad64_x4",
                        *(f"pair_ms_{v}" for v in others),
                        *(f"{v}_vs_f32_{m}_mean" for v in others for m in ("epe", "rel"))}
    assert res["hw"] == [64, 64] and res["iters"] == 2 and res["device"] == "cpu"
    assert all(res[k] > 0 for k in res if k.startswith("pair_ms_"))
    assert all(0 <= res[f"{v}_vs_f32_epe_mean"] < float("inf") for v in others)
    # bf16 moves the flow, but far less than the flow itself
    assert 0 < res["bf16_full_vs_f32_rel_mean"] < 0.2


def test_reflect_pad_in_batch_chunks_is_exact(monkeypatch):
    """Batches past 32-bit indexing (the bench's bf16_b128 decoder) are
    padded in chunks; the result is the one-call pad's."""
    x = torch.randn(5, 3, 6, 7)
    whole = image.reflect_pad(x, 2)
    monkeypatch.setattr(image, "MAX_32BIT_NUMEL", 2 * 3 * 10 * 11)  # two samples a chunk
    torch.testing.assert_close(image.reflect_pad(x, 2), whole, atol=0, rtol=0)
    monkeypatch.setattr(image, "MAX_32BIT_NUMEL", 1)  # one sample a chunk
    torch.testing.assert_close(image.reflect_pad(x, 2), whole, atol=0, rtol=0)
