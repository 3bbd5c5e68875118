"""Share (%) of the prompt tokens admitted in the window that the Server
took from a slot's cache instead of prefilling them (``Server.stats()``
``cached_prompt_tokens`` over those and ``prefill_tokens``)."""


def read(run):
    c = run.stats_close["cached_prompt_tokens"] \
        - run.stats_open["cached_prompt_tokens"]
    p = run.stats_close["prefill_tokens"] - run.stats_open["prefill_tokens"]
    return 100.0 * c / (c + p) if c + p > 0 else None
