"""Logging helper (equivalent of reference utils/logutils.py:1-15)."""

__all__ = ["printlog"]


def printlog(s, filename=None, quiet=False, end="\n"):
    """Append a string to the log file and optionally print it to stdout."""
    if filename is not None:
        with open(filename, "a") as f:
            f.write(str(s) + end)
    if not quiet:
        print(s, end=end)
