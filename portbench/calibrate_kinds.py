"""calibrate.py for every traffic kind: a kind whose module brings its own
`control(ctx, data)` (traffic/train_draws.py) is read
through it, any other as calibrate.py reads it. The arguments and the
readings are calibrate.py's:

    python3 -m portbench.calibrate_kinds --workload <cell> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--seconds S] [--out FILE]
"""

import sys

from portbench import calibrate

_control = calibrate.control


def control(ctx, data):
    """The kind's own control, or calibrate.control."""
    own = getattr(ctx.cell.kind, "control", None)
    return own(ctx, data) if own else _control(ctx, data)


def main(argv=None):
    calibrate.control = control
    try:
        return calibrate.main(argv)
    finally:
        calibrate.control = _control


if __name__ == "__main__":
    sys.exit(main())
