"""The GAN trainers' data against vst's, bit for bit, on a synthetic corpus
written to ``tmp_path`` by ``vst_torch.data.datagen.generate_fc2_corpus`` (procedural styler):
``DeviceStyledCache``'s three samplers (the same numpy draws, the same
uint8 / float16 tables, the same dequantization; the port's NCHW against
vst's NHWC) and ``FC2Fetcher`` (batches and latents)."""

import os

import numpy as np
import pytest
import torch

from vst.data.device_cache import DeviceStyledCache as JDeviceStyledCache
from vst.data.fc2 import DatasetFC2 as JDatasetFC2
from vst.data.fc2 import FC2Fetcher as JFC2Fetcher
from vst.data.fc2 import FC2Loader as JFC2Loader
from vst_torch.data.device_cache import DeviceStyledCache
from vst_torch.data.datagen import generate_fc2_corpus
from vst_torch.data.fc2 import DatasetFC2, FC2Fetcher, FC2Loader

HW = (24, 32)
NUM_DOM = 3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("styled"))
    generate_fc2_corpus(root, 7, hw=HW, seed=3, styler="procedural", device="cpu")
    return root


def as_vst(batch):
    """The port's batch in vst's layout: images NHWC, labels int32 numpy."""
    out = {}
    for k, v in batch.items():
        v = v.numpy()
        out[k] = v.transpose(0, 2, 3, 1) if v.ndim == 4 else v.astype(np.int32)
    return out


def assert_same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        assert np.array_equal(got[k], w), k


def test_corpus_layout(corpus):
    for tree in ("styled-files", "styled-files3"):
        # the content and the corpus's 3 styles; the readers take the first NUM_DOM
        assert sorted(os.listdir(os.path.join(corpus, tree))) == [f"style{d}" for d in range(4)]
    assert len(os.listdir(os.path.join(corpus, "styled-files3", "style2"))) == 7
    d = np.load(os.path.join(corpus, "DATAFiles", "0000004.npy"))
    assert d.shape == (1, *HW, 9) and d.dtype == np.float32


@pytest.mark.parametrize("sampler", ["sample", "sample_multidomain", "sample_cyclegan"])
def test_device_styled_cache_is_vsts(corpus, sampler):
    port = DeviceStyledCache(corpus, num_dom=NUM_DOM, limit=6, seed=5, device="cpu")
    ref = JDeviceStyledCache(corpus, num_dom=NUM_DOM, limit=6, seed=5)
    assert (port.n, port.num_dom) == (ref.n, ref.num_dom) == (6, NUM_DOM)
    args = (5, 2) if sampler == "sample_cyclegan" else (5,)
    for _ in range(3):  # the draws go on in step
        got, want = getattr(port, sampler)(*args), getattr(ref, sampler)(*args)
        assert_same(as_vst(got), {k: np.asarray(v) for k, v in want.items()})
        if sampler != "sample_cyclegan":
            assert got["y_src"].dtype == torch.long
    img = got["x_src" if sampler != "sample_cyclegan" else "real_A"]
    assert float(img.abs().max()) <= 1.0 + 2 ** -23  # 255·float32(2/255) − 1 is 1 + 1 ulp


def test_fc2_fetcher_is_vsts(corpus):
    """Two epochs of 3 batches of 2 (the fetcher restarts the loader), with
    the same z_trg / z_trg2 draws."""
    dirs = [os.path.join(corpus, d) for d in ("DATAFiles", "styled-files", "styled-files3")]
    port = FC2Fetcher(FC2Loader(DatasetFC2(*dirs, num_dom=NUM_DOM, base_len=None), range(7), 2,
                                seed=1), latent_dim=4, seed=2)
    ref = JFC2Fetcher(JFC2Loader(JDatasetFC2(*dirs, num_dom=NUM_DOM, base_len=None), range(7), 2,
                                 seed=1), latent_dim=4, seed=2)
    for _ in range(7):
        assert_same(next(port), next(ref))
