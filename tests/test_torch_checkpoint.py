"""vst_torch's ``Checkpointer`` (the port's counterpart of vst's orbax one,
``vst/core/checkpoint.py``): vst's API (``save(step, **trees)``,
``restore(step, **likes)``, ``latest_step()``, None on an empty directory)
over the torch files the CLI writes, one layout a family; every tensor
restored bit for bit onto the CPU. The CLI's loaders read through it
(``load_state``, StarGAN v2's / v1's / the CycleGAN family's evaluation
nets, the demo's net)."""

import os
import types

import pytest
import torch

from vst_torch.cli.__main__ import (CKPT_NAME, cyclegan_eval_generators, load_state,
                                    stargan2_eval_nets, stargan_eval_generator)
from vst_torch.cli.demo import DemoStylizer
from vst_torch.core import Checkpointer
from vst_torch.core.checkpoint import LAYOUTS
from vst_torch.models.cyclegan import ResnetGenerator
from vst_torch.models.stargan import Generator as StarGANGenerator
from vst_torch.train.registry import method_net
from vst_torch.train.stargan2 import StarGAN2Config, StarGAN2Trainer

# each family's layout and the file names its command has always written
NAMES = {"faststyle": (None, ("model",), ["model.pt"]),
         "stargan2": (12, ("nets", "nets_ema"), ["000012_nets.ckpt", "000012_nets_ema.ckpt"]),
         "stargan": (12, ("G", "D"), ["12-D.ckpt", "12-G.ckpt"]),
         "cyclegan": (12, ("G_A", "D_A"), ["12_net_D_A.pth", "12_net_G_A.pth"])}
SMALL_V2 = dict(img_size=32, style_dim=8, latent_dim=4, num_domains=3, max_conv_dim=32)


def _net(seed):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_equal(got[k], v)
        else:
            assert torch.equal(got[k], v) and got[k].device.type == "cpu", k


@pytest.mark.parametrize("family", sorted(NAMES))
def test_round_trip_under_each_familys_names(tmp_path, family):
    step, names, files = NAMES[family]
    ckpt = Checkpointer(str(tmp_path), LAYOUTS[family])
    trees = {name: ({"a": _net(1).state_dict(), "b": _net(2).state_dict()}
                    if family == "stargan2" else _net(i).state_dict())
             for i, name in enumerate(names)}
    paths = ckpt.save(step, **trees)
    assert sorted(os.listdir(tmp_path)) == files
    assert sorted(os.path.basename(p) for p in paths) == files
    _assert_equal(ckpt.restore(step, **{n: None for n in names}),
                  {n: {k: v for k, v in t.items() if not k.endswith("num_batches_tracked")}
                   if family != "stargan2" else t for n, t in trees.items()})
    if family != "stargan2":  # a module passed as ``like`` is loaded and returned
        into = _net(99)
        out = ckpt.restore(step, **{names[0]: into})[names[0]]
        assert out is into
        _assert_equal(out.state_dict(), _net(0).state_dict())


def test_a_module_is_saved_as_its_state_dict(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "run"), LAYOUTS["cyclegan"])
    net = _net(3)
    ckpt.save(5, G_A=net)
    assert os.listdir(tmp_path / "run") == ["5_net_G_A.pth"]
    _assert_equal(torch.load(tmp_path / "run" / "5_net_G_A.pth"), net.state_dict())


def test_latest_step(tmp_path):
    assert Checkpointer(str(tmp_path / "absent"), LAYOUTS["stargan"]).latest_step() is None
    assert not os.path.exists(tmp_path / "absent")  # nothing is made by reading
    for family in ("stargan2", "stargan", "cyclegan"):
        d = tmp_path / family
        ckpt = Checkpointer(str(d), LAYOUTS[family])
        d.mkdir()
        assert ckpt.latest_step() is None
        for step in (3, 40, 7):
            ckpt.save(step, G=_net(0).state_dict())
        (d / "losses.txt").write_text("")
        (d / "sample_000040.png").write_text("")
        assert ckpt.latest_step() == 40
        assert sorted(ckpt.entries()) == [(3, "G"), (7, "G"), (40, "G")]
    faststyle = Checkpointer(str(tmp_path / "fs"), LAYOUTS["faststyle"])
    faststyle.save(None, model=_net(0))
    assert faststyle.latest_step() is None and faststyle.entries() == [(None, "model")]


def test_a_file_of_any_name_and_the_cleaned_state_dict(tmp_path):
    """A converted reference checkpoint (any name, DataParallel's
    ``module.`` prefix, batch norms' ``num_batches_tracked``) reads through
    ``Checkpointer.file`` and the CLI's ``load_state``."""
    sd = _net(4).state_dict()
    path = tmp_path / "weird {name} ep10.pth"
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    want = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    _assert_equal(load_state(str(path)), want)
    _assert_equal(Checkpointer.file(str(path)).restore(None, x=None)["x"], want)
    assert CKPT_NAME == "model.pt"


def test_the_cli_loaders_read_the_families_files(tmp_path):
    """StarGAN v2's ``_nets_ema.ckpt``, v1's ``-G.ckpt``, each CycleGAN
    dir's newest ``_net_G_A.pth`` and the demo's ``model.pt`` (a file or a
    train dir) load through the Checkpointer into the evaluation nets."""
    cfg = StarGAN2Config(**SMALL_V2)
    trainer = StarGAN2Trainer(cfg, seed=3, device="cpu")
    paths = Checkpointer(str(tmp_path / "v2"), LAYOUTS["stargan2"]).save(
        2, nets=trainer.state_dicts(), nets_ema=trainer.state_dicts(use_ema=True))
    nets = stargan2_eval_nets(types.SimpleNamespace(ckpt_dir=paths[1], seed=0), cfg, "cpu")
    _assert_equal(nets["generator"].state_dict(), trainer.ema["generator"].state_dict())

    torch.manual_seed(5)
    g = StarGANGenerator(8, 3, 2)
    path, = Checkpointer(str(tmp_path / "v1"), LAYOUTS["stargan"]).save(4, G=g)
    got = stargan_eval_generator(types.SimpleNamespace(ckpt_dir=path, seed=0),
                                 types.SimpleNamespace(conv_dim=8, c_dim=3, repeat_num=2), "cpu")
    _assert_equal(got.state_dict(), g.state_dict())

    ckpt = Checkpointer(str(tmp_path / "cg"), LAYOUTS["cyclegan"])
    for step, seed in ((2, 6), (10, 7)):
        torch.manual_seed(seed)
        newest = ResnetGenerator(3, 3, 8, 2)
        ckpt.save(step, G_A=newest, D_A=_net(0))
    got, = cyclegan_eval_generators(f"cyclegan:{tmp_path / 'cg'}", "cpu")
    _assert_equal(got.state_dict(), newest.state_dict())

    torch.manual_seed(8)
    net = method_net("huang", 3)
    Checkpointer(str(tmp_path / "fs"), LAYOUTS["faststyle"]).save(None, model=net)
    for where in (tmp_path / "fs", tmp_path / "fs" / CKPT_NAME):
        demo = DemoStylizer("huang", 3, str(where), seed=0, device="cpu")
        _assert_equal(demo.net.state_dict(), net.state_dict())
