"""Command-line entry points: `python -m jdet_torch.tools.run_net` and
`python -m jdet_torch.tools.merge_results`."""
