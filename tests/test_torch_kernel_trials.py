"""The design-trial probe (``vst_torch.probes.kernel_trials``) cuts parts out
of the kernels' sources by replacing text; each text it replaces must still
be in the source, or the probe would fail on the card."""

import pytest

from vst_torch.kernels import _nvcc
from vst_torch.probes import kernel_trials


@pytest.mark.parametrize("name,variant", [
    ("corr_lookup", v) for v in kernel_trials.CORR_VARIANTS] + [
    ("pad_conv3x3", v) for v in kernel_trials.CONV_VARIANTS] + [
    ("pad_conv3x3", v) for v in kernel_trials.HALO_VARIANTS])
def test_variant_edits_apply(name, variant):
    table = (kernel_trials.CORR_VARIANTS if name == "corr_lookup" else
             {**kernel_trials.CONV_VARIANTS, **kernel_trials.HALO_VARIANTS})
    source = (_nvcc.CSRC / f"{name}.cu").read_text()
    for old, new in table[variant]:
        assert source.count(old) == 1
        assert new != old
