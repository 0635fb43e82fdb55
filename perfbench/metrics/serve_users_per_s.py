"""Users whose top-k lists reached the host in the window, over the
window's whole time. Host clock."""


def read(run):
    if run.kind != "serve" or not run.requests:
        return None
    return run.requests * run.users_per_request / run.window_s
