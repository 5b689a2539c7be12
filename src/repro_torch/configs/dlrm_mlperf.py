"""dlrm-mlperf [recsys] n_dense=13 n_sparse=26 embed_dim=128
bot_mlp=13-512-256-128 top_mlp=1024-1024-512-256-1 interaction=dot —
MLPerf DLRM benchmark config (Criteo 1TB) [arXiv:1906.00091; paper].

MLPerf per-table vocabs range 10^4..4*10^7 (~880M rows total); we use a
uniform 4M rows/table (104M rows, 53 GB fp32) so the row-sharded tables +
row-wise-adagrad state fit the 16-chip 'model' axis of the assigned mesh
(DESIGN.md §4). The lookup path is identical at any vocab."""

from repro_torch.models.recsys import DLRMConfig

KIND = "recsys"


def config() -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-mlperf", n_dense=13, n_sparse=26, embed_dim=128,
        vocab_per_table=4_000_000, bot_mlp=(512, 256, 128),
        top_mlp=(1024, 1024, 512, 256, 1), interaction="dot")


def smoke_config() -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-smoke", n_dense=13, n_sparse=26, embed_dim=16,
        vocab_per_table=1000, bot_mlp=(32, 16), top_mlp=(64, 32, 1),
        interaction="dot")
