"""Scheduler: host ms ``SliceScheduler.next_action`` took in the window
(the port's ``GapStats.schedule_ms``), per action it returned."""


def read(w):
    if w.loop.actions_window <= 0:
        return None
    return w.loop.schedule_ms_window / w.loop.actions_window
