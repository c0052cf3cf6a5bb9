# coding: utf-8
"""Stream + file logger with the reference's line shapes (copy of
`foodrec_tpu/utils/logger.py:19-51`; reference FoodRec/utils/logger.py:9-59)."""

import logging
import os

from foodrec_tpu_torch.parallel.mesh import process_rank
from foodrec_tpu_torch.utils.misc import get_local_time

_LEVELS = {
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "error": logging.ERROR,
    "warning": logging.WARNING,
    "critical": logging.CRITICAL,
}


def init_logger(config):
    """Log to the console and to `{log_root}/{model}-{dataset}-{time}.log`;
    the root logger's handlers are replaced, so a second experiment in the
    same process logs to its own file only. Under a launcher only rank 0
    logs; the other ranks print warnings and errors only."""
    root = logging.getLogger()
    for handler in root.handlers:
        handler.close()
    root.handlers.clear()
    if process_rank() != 0:
        root.setLevel(logging.WARNING)
        return
    log_root = config["log_root"] or "./log/"
    os.makedirs(log_root, exist_ok=True)

    logfilename = "{}-{}-{}.log".format(
        config["model"], config["dataset"], get_local_time()
    )
    logfilepath = os.path.join(log_root, logfilename)

    state = (config["state"] or "info").lower()
    level = _LEVELS.get(state, logging.INFO)

    fileformatter = logging.Formatter(
        "%(asctime)-15s %(levelname)s %(message)s", "%a %d %b %Y %H:%M:%S"
    )
    sformatter = logging.Formatter(
        "%(asctime)-15s %(levelname)s %(message)s", "%d %b %H:%M"
    )

    fh = logging.FileHandler(logfilepath, "w", "utf-8")
    fh.setLevel(level)
    fh.setFormatter(fileformatter)

    sh = logging.StreamHandler()
    sh.setLevel(level)
    sh.setFormatter(sformatter)

    root.setLevel(level)
    root.addHandler(sh)
    root.addHandler(fh)
