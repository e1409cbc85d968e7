"""Graph neural networks: the single-device GraphCast and GAT forwards
(:mod:`.gnn`), their 2D-partitioned forwards on a simulated grid with the
optional int8 payload (:mod:`.gnn_dist`), and GraphCast's multimesh
(:mod:`.icosahedron`, a numpy copy)."""
