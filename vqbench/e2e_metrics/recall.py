"""recall: recall@k at the cell's k over every answer the window gave,
against the pool's exact top-k (f32 over the uncompressed corpus, worked
out after the window)."""

from vqbench.reference import common


def read(run):
    k = run.mix["k"]
    return common.recall_at_k(common.exact_topk(run.pool, run.corpus, k), run.answers, k)
