"""meshgraphnet [gnn] n_layers=15 d_hidden=128 aggregator=sum mlp_layers=2
— [arXiv:2010.03409; unverified]. Feature dims vary per graph shape; the
config carries the processor geometry and the caller passes each shape's
input dims."""

from repro_torch.models.gnn import GNNConfig

KIND = "gnn"


def config(node_in: int = 16, edge_in: int = 8,
           node_out: int = 3) -> GNNConfig:
    return GNNConfig(
        name="meshgraphnet", node_in=node_in, edge_in=edge_in,
        node_out=node_out, n_layers=15, d_hidden=128, mlp_layers=2,
        aggregator="sum", dtype="float32")


def smoke_config() -> GNNConfig:
    return GNNConfig(
        name="meshgraphnet-smoke", node_in=8, edge_in=4, node_out=3,
        n_layers=3, d_hidden=32, mlp_layers=2, aggregator="sum",
        dtype="float32")
