"""The port's experiment entry points, each run as
`python -m efficient_rpe_vit_torch.experiments.<name>`."""
