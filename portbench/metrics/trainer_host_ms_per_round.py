"""The host's enqueue time of a round: the benchmark's span around
``update_all`` and ``finish_round``, up to the ``synchronize()`` that ends
the round, averaged over the window's rounds."""


def read(ctx):
    return 1e3 * sum(ctx.enqueue_s) / len(ctx.enqueue_s)
