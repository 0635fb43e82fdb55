"""Training rows (filler rows of a padded last batch not counted) of the
whole epochs in the window, over the window's whole time, epoch builds and
uploads included. Host clock."""


def read(run):
    if run.kind != "fit" or not run.epochs:
        return None
    return run.examples / run.window_s
