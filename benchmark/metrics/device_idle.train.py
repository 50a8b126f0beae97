"""``device_idle.train`` (%, layer device): 1 - the union of the device
operations' intervals (kernels, memcpy, memset; overlaps counted once) over
the traced window's length, a window of whole steps of one ``train_epoch``
call."""


def read(run):
    if run.traffic["kind"] != "train" or run.traced is None:
        return None
    return 100.0 * (1.0 - run.traced["busy_s"] / run.traced["window_s"])
