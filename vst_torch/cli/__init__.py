"""The port's command line: ``python -m vst_torch.cli <subcommand>``, each of
vst's 16 subcommands."""
