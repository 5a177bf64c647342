"""Command-line tools of the port: ``python -m deeplearning4j_tpu_torch.tools.serve``."""
