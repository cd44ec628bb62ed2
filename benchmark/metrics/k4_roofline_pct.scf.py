"""k4_roofline_pct.scf: K4's share of its roofline over the traced window, in %: the
bound of the work the inputs need (``roofline.py``, the light cone of each
chain) over the device time of the ``block_step`` kernels; none without a
trace or a K4 launch."""


def read(run):
    if run.trace is None:
        return None
    t = run.trace.seconds("block_step_kernel")
    return 100.0 * run.k4_bound_s() / t if t > 0 else None
