"""Output tokens per second over the window: every token emitted inside
it over its length, the step that crosses its end counted in proportion
(``stats.output_tok_s``)."""

from portbench import stats


def read(rec):
    return stats.output_tok_s(rec)
