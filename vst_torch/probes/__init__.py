"""Probes of the Hopper kernels at the shapes of the stylize benchmark,
ports of the TPU scripts ``scripts/bisect_{im2col,kernel_cost,mxu}.py``.
Each runs on the card (``python -m vst_torch.probes.<name>``), prints its
times beside the plain version's, the library yardstick's and the bound,
and exposes ``run()`` returning the same numbers. They need a CUDA device.
"""
