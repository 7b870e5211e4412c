"""Message-passing convolutions (counterpart of euler_tpu/convolution/):
the eleven that the node-classification runners use, GatedGraphConv,
which the gated_graph runner uses, and the relational RelationConv."""

from euler_tpu_torch.convolution.conv import (  # noqa: F401
    Conv, aggregate, split_x,
)
from euler_tpu_torch.convolution.agnn_conv import AGNNConv  # noqa: F401
from euler_tpu_torch.convolution.appnp_conv import APPNPConv  # noqa: F401
from euler_tpu_torch.convolution.arma_conv import ARMAConv  # noqa: F401
from euler_tpu_torch.convolution.dna_conv import DNAConv  # noqa: F401
from euler_tpu_torch.convolution.gat_conv import GATConv  # noqa: F401
from euler_tpu_torch.convolution.gated_graph_conv import (  # noqa: F401
    GatedGraphConv,
)
from euler_tpu_torch.convolution.gcn_conv import GCNConv  # noqa: F401
from euler_tpu_torch.convolution.gin_conv import GINConv  # noqa: F401
from euler_tpu_torch.convolution.graph_conv import GraphConv  # noqa: F401
from euler_tpu_torch.convolution.relation_conv import (  # noqa: F401
    RelationConv,
)
from euler_tpu_torch.convolution.sage_conv import SAGEConv  # noqa: F401
from euler_tpu_torch.convolution.sgcn_conv import SGCNConv  # noqa: F401
from euler_tpu_torch.convolution.tag_conv import TAGConv  # noqa: F401
