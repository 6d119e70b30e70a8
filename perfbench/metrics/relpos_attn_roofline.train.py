"""relpos_attn_roofline.train: the least time of the window's attention
op calls with the decomposed relative-position bias (forward and backward
of each windowed and each global block of each step, `counts/sam.py`, from
the cell's shapes alone) over the measured time of the kernels of group
`flash`."""

from perfbench import spec


def read(trace, run):
    measured = trace.group_s("flash")
    if trace.steps == 0 or measured <= 0:
        return None
    counts = spec.counts("sam")
    least = counts.op_least_seconds(run["config"], run["mix"], run["peak"])
    calls = counts.attention_calls(run["config"])
    per_step = sum(calls[kind] * (least[kind]["forward"] + least[kind]["backward"])
                   for kind in calls)
    return 100.0 * trace.steps * per_step / measured
