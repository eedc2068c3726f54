"""Tokens trained a second: clients x local steps x batch x seq a round
(the GNB's passes not counted), times the rounds that completed in the
window, over the window's seconds (host clock, from a synchronise before
the first round to the synchronise after the last)."""


def read(run):
    if run.trace is not None or not run.window_s:
        return None
    return run.rounds * run.tokens_per_round / run.window_s
