"""The port's chain server: ``python -m generativeaiexamples_tpu_torch.server``."""
