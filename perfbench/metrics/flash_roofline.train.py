"""flash_roofline.train: the least time of the window's softmax op calls
(forward and backward of each layer of each step, `counts/softmax.py`, from
the cell's shapes alone) over the measured time of the kernels of group
`flash`."""

from perfbench import spec


def read(trace, run):
    measured = trace.group_s("flash")
    if trace.steps == 0 or measured <= 0:
        return None
    least = spec.counts("softmax").op_least_seconds(run["config"], run["mix"], run["peak"])
    calls = trace.steps * run["config"]["depth"]
    return 100.0 * calls * (least["forward"] + least["backward"]) / measured
