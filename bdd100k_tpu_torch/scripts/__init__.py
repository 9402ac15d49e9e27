"""Command-line tools of the port (`python -m bdd100k_tpu_torch.scripts.<name>`)."""
