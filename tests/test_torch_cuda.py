"""The Hopper kernels on the card: corr_lookup against its plain version and
RAFT through it against RAFT with the plain lookup. Marked ``cuda``; they
skip where there is no CUDA device. On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import pytest
import torch

from vst_torch.flow.corr import build_pyramid, lookup_pyramid
from vst_torch.flow.raft import RAFT, coords_grid
from vst_torch.kernels.corr_lookup import corr_lookup

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the corr_lookup kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("B,H,W,C", [(1, 8, 16, 32), (2, 55, 128, 64)])
def test_kernel_matches_plain(dev, B, H, W, C):
    g = torch.Generator(device=dev).manual_seed(0)
    pyr = build_pyramid(torch.randn(B, C, H, W, generator=g, device=dev),
                        torch.randn(B, C, H, W, generator=g, device=dev), 4)
    coords = (coords_grid(B, H, W, device=dev)
              + 8 * torch.randn(B, 2, H, W, generator=g, device=dev)).contiguous()
    before = corr_lookup.launches
    got = corr_lookup(pyr, coords, 4)
    torch.cuda.synchronize()
    assert corr_lookup.launches == before + 1
    torch.testing.assert_close(got, lookup_pyramid(pyr, coords, 4), atol=1e-5, rtol=0)


def test_raft_through_the_kernel_matches_plain_lookup(dev):
    torch.manual_seed(0)
    fast = RAFT(iters=4).to(dev).eval()
    plain = RAFT(iters=4, lookup=lookup_pyramid).to(dev).eval()
    plain.load_state_dict(fast.state_dict())
    g = torch.Generator(device=dev).manual_seed(1)
    i1 = 255 * torch.rand(2, 3, 64, 96, generator=g, device=dev)
    i2 = 255 * torch.rand(2, 3, 64, 96, generator=g, device=dev)
    with torch.no_grad():
        _, up_fast = fast(i1, i2)
        _, up_plain = plain(i1, i2)
    torch.testing.assert_close(up_fast, up_plain, atol=1e-3, rtol=0)
