"""The share of one profiled warm solve's wall in which no kernel, copy or
memset ran on the device: 100 (wall - union of device intervals) / wall."""


def read(run):
    if run.profile is None or not run.profile.busy_s:
        return None
    return 100 * (run.profile.window_s - run.profile.busy_s) / run.profile.window_s
