"""vst_torch's Ruder streaming driver (``evaluate_sintel_ruder``) against
vst's on frames from vst's own generator at 32×48, 3 styles: the 7-input
net and the 3-input bootstrap carry the same weights on both sides, and the
flow comes from the generator's oracle or from RAFT (2 GRU iterations,
weights carried across). Every per-video TCL key and its means within 1e-4
relative, as ``tests/test_torch_sintel.py`` (measured on a CPU: 6.1e-7 with
the oracle and 5.4e-6 through RAFT)."""

import types

import numpy as np
import pytest
import torch

from vst.data.synthetic import AffineMotionGenerator, _texture
from vst.eval.drivers import evaluate_sintel_ruder as jevaluate_sintel_ruder
from vst.flow.raft import RAFT as JRAFT
from vst.flow.raft import raft_params_from_torch
from vst.models.faststyle import FastStyleNet as JFastStyleNet
from vst.models.faststyle import faststyle_params_from_torch
from vst_torch.eval.drivers import evaluate_sintel_ruder
from vst_torch.eval.sintel import SintelVideo
from vst_torch.flow.raft import RAFT
from vst_torch.train.registry import bootstrap_net, method_net

HW = (32, 48)
RTOL_TCL = 1e-4
N_FRAMES = 7  # two frames past the long-term offset of 5


def _spread(net):
    with torch.no_grad():  # spread the output over [0, 255] instead of ~127.5
        net.deconv3.conv2d.weight.mul_(300.0)
    return net.eval()


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    gen = AffineMotionGenerator(crop_hw=HW, seed=1)
    frames, _, _ = gen.generate(_texture(rng, (HW[0] + 96, HW[1] + 96)), n_frames=N_FRAMES)
    torch.manual_seed(0)
    net, pre = _spread(method_net("ruder", 3)), _spread(bootstrap_net(3))
    raft = RAFT(iters=2).eval()
    jtrainer = types.SimpleNamespace(model=JFastStyleNet(num_inp=7, n_styles=3),
                                     pre_model=JFastStyleNet(num_inp=3, n_styles=3))
    jparams = faststyle_params_from_torch(net.state_dict())
    jpre = faststyle_params_from_torch(pre.state_dict())
    jraft, jraft_params = JRAFT(small=False, iters=2), {
        "params": raft_params_from_torch(raft.state_dict())}

    def port(flow_fn):
        return evaluate_sintel_ruder(net, net.state_dict(), pre, pre.state_dict(),
                                     [SintelVideo("toy", frames)], lambda a, b: raft(a, b),
                                     flow_fn=flow_fn, device="cpu")

    def ref(flow_fn):
        return jevaluate_sintel_ruder(jtrainer, jparams, jpre, [SintelVideo("toy", frames)],
                                      lambda a, b: jraft.apply(jraft_params, a, b),
                                      flow_fn=flow_fn)

    return port, ref, gen


@pytest.mark.parametrize("flow", ["oracle", "raft"])
def test_ruder_driver_matches_vst(setup, flow):
    port, ref, gen = setup
    flow_fn = (lambda video, i, j: gen.pairwise_flows(j, i)) if flow == "oracle" else None
    got, want = port(flow_fn), ref(flow_fn)
    assert set(got) == set(want) == {"TCL-ST", "TCL-LT", "DT"}
    for out_id in ("TCL-ST", "TCL-LT"):
        assert set(got[out_id]) == set(want[out_id])
        assert len(want[out_id]) == 3 + 1 + 3  # per style, the mean, per-style means
        for k, v in want[out_id].items():
            assert v > 1e-3, k  # the comparison is not 0 = 0
            np.testing.assert_allclose(got[out_id][k], v, rtol=RTOL_TCL, err_msg=k)
    assert set(got["DT"]) == set(want["DT"]) and got["DT"]["DT_mean"] > 0


def test_ruder_writes_the_reference_jsons(setup, tmp_path):
    gen = setup[2]
    net, pre = method_net("ruder", 1).eval(), bootstrap_net(1).eval()
    res = evaluate_sintel_ruder(
        net, net.state_dict(), pre, pre.state_dict(),
        [SintelVideo("toy", np.zeros((3, *HW, 3), np.float32))], None, styles=(0,),
        out_path=str(tmp_path), flow_fn=lambda video, i, j: gen.pairwise_flows(j, i),
        device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["DT.json", "TCL-LT.json",
                                                          "TCL-ST.json"]
    assert res["TCL-LT"]["TCL-LT_toy_s1"] == 0.0  # 3 frames: no frame 5 back
