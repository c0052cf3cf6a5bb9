"""train_pairs_per_s: training pairs (user, positive, sampled negative)
whose optimizer step completed in the window, over the window's seconds;
the window ends on a synchronize after its last step."""


def read(run):
    return run.window["pairs"] / run.window["window_s"]
