"""What the front end's and the filter's counter readers share."""
import torch


def total(run, name):
    """The sum over the window's ticks and rows of a collected counter, as
    a float; None where the run collected none."""
    xs = run.collected.get(name)
    if not xs:
        return None
    return float(torch.cat([x.reshape(-1) for x in xs]).double().sum())


def per_row_tick(run, *names):
    """The mean over the window's rows and ticks of the named counters'
    sum; None where the run collected none."""
    parts = [total(run, n) for n in names]
    xs = run.collected.get(names[0])
    if None in parts:
        return None
    return sum(parts) / sum(x.numel() for x in xs)


def share(run, part, whole):
    """100 sum(part) / sum(whole) over the window; None where whole is 0
    or uncollected."""
    a, b = total(run, part), total(run, whole)
    return 100.0 * a / b if a is not None and b else None
