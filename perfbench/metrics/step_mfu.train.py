"""step_mfu.train: the model FLOPs of the traced window's train steps (3x
the forward, no recompute, from the configuration's shapes by
`counts/<attention>.py`) over the window's length, as a share of the card's
dense peak in the configuration's compute dtype."""


def read(trace, run):
    if trace.steps == 0 or trace.window_s <= 0:
        return None
    flops = run["counts"].train_flops_per_step(run["config"], run["mix"]) * trace.steps
    peak = run["peak"][f"{run['config']['compute_dtype']}_flops_per_s"]
    return 100.0 * flops / trace.window_s / peak
