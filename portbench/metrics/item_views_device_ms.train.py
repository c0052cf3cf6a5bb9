"""item_views_device_ms.train: device milliseconds a step of the operations
launched inside the program's `foodrec::item_views` spans (CLUSSL's three
item-side views: the item-ingredient and the two cluster graphs' forward
propagation and their sum; their backward is not counted), in the traced
training window; None where the program opens no such span."""

from portbench.spans import device_seconds_inside, ms_per


def read(run):
    s = device_seconds_inside(run.trace, "foodrec::item_views")
    return ms_per(s, run.traced["steps"])
