"""eval_users_per_s: users whose by-user metrics were complete on the host
in the window's whole evaluation passes, over the window's seconds."""


def read(run):
    return run.window["users"] / run.window["window_s"]
