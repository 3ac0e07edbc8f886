"""Users whose channels or beam-gain maps were completed, over the whole
window, which ends in a synchronise (one caller: each call returns before
the next starts; a host result is complex numpy in the caller's hands)."""


def read(w):
    return w.users / w.window_s
