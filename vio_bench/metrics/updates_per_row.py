"""updates_per_row: features used in the visual updates
(FrameOutput.n_update_features), averaged over rows and the window's
ticks (the filter layer)."""
import torch


def read(run):
    xs = run.collected.get("n_upd")
    if not xs:
        return None
    return float(torch.cat([x.reshape(-1) for x in xs]).double().mean())
