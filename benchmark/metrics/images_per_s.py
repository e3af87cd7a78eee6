"""Images completed over the window's wall time: the host clock from the
first batch (or request) sent to the last results read back to the host."""


def read(rec):
    return rec['window']['images_per_s']
