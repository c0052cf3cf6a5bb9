"""train_mfu: the whole training step's share of the chip's float32 peak.
The configuration's FLOPs of one step at each batch size the window ran
(configs/<config>.py, from the shapes), summed over the steps of the
untraced window, over its seconds, over 67 TFLOP/s: the port computes in
float32 with TF32 off, so its products run outside the tensor cores."""

from portbench import peaks


def read(run):
    if run.ctx.device == "cpu":
        return None  # a share of the GPU's peak; nothing to read off it
    f = run.cell.flops
    total = sum(n * f.step_flops(run.shapes, run.graphs, b,
                                      run.ctx.config["model_config"])
                for b, n in run.window["steps_by_batch"].items())
    return 100.0 * total / run.window["window_s"] / peaks.FP32_FLOPS_PER_S
