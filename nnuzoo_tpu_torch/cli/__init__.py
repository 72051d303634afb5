"""The port's command line: ``python -m nnuzoo_tpu_torch.cli <subcommand> ...``."""
