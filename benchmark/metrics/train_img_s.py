"""Images trained per second: every image of every step in the window,
over the window's whole time, which ends once the card has finished
(host clock)."""


def read(run):
    w = run.window
    if w is None or run.cell.traffic["mode"] != "train":
        return None
    return w["images"] / w["seconds"]
