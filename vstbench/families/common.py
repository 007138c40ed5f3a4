"""What the families share: the program's nets built with the reference's
weights, without drawing weights of their own."""

from __future__ import annotations

import torch


def port(make, state, device) -> torch.nn.Module:
    """``make()`` built on the meta device, moved to ``device`` and given
    ``state`` (every entry of its ``state_dict``), in eval mode."""
    with torch.device("meta"):
        net = make()
    net = net.to_empty(device=device)
    net.load_state_dict(state)
    return net.eval()
