"""Prompt plus generated tokens of every batch over the time from the
window's start to the end of the last batch begun inside it."""

from benchlib.readers import field


def read(run):
    tokens = field(run, "tokens")
    if not tokens:
        return None
    return sum(tokens) / (run.items[-1]["end"] - run.items[0]["start"])
