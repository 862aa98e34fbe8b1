"""Device seconds of host-to-device and device-to-host copies in one
profiled warm solve."""


def read(run):
    if run.profile is None or not run.profile.ops:
        return None
    return run.profile.copy_seconds()
