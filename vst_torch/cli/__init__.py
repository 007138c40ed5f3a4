"""The port's command line: ``python -m vst_torch.cli {bench,bench-raft}``."""
