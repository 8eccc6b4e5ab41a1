"""Mean host milliseconds of the ``track`` section of ``NiceSLAM.step``
(its ``StepTimer``) per frame of the window. In strict sync the section
ends after the host has read the pose back, so it covers the device's
work."""


def read(ctx):
    w = ctx.window
    if not w.tracked or not w.track_n:
        return None
    return 1e3 * w.track_s / w.track_n
