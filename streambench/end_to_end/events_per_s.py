"""Events the source handed out in the window over the whole window, from
the first poll until ``execute`` returned (the final flush inside)."""


def read(run):
    return run.events / run.window_s
