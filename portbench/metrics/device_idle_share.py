"""``device_idle_share.<cells>``: the share of the window in which no
kernel, copy or fill ran on the card (``torch.profiler``), one name for
each end-to-end rate it moves."""
from portbench.measure import idle_share


def read(run):
    return idle_share(run)
