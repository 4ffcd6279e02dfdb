from .csr import GraphCSR
from .datasets import complete_graph, erdos_renyi, rmat, load_edge_list, named_dataset
