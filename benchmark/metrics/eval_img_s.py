"""Images validated per second: every image of every ``eval_step`` call
in the window, over the window's whole time, which ends once the card has
finished (host clock)."""


def read(run):
    w = run.window
    if w is None or run.cell.traffic["mode"] != "eval":
        return None
    return w["images"] / w["seconds"]
