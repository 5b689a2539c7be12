"""Share of the index's clusters a query scores (``TopK``'s
``n_scored_clusters`` over m), mean over the window's queries: what the
(mu, eta) admission lets through."""


def read(rec: dict):
    n_q = sum(rec["batches"]["n_q"])
    if not n_q:
        return None
    return sum(rec["batches"]["scored_clusters"]) / (n_q * rec["m"])
