"""Graph neural networks: the single-device GraphCast, GAT, EGNN and NequIP
forwards (:mod:`.gnn`), their 2D-partitioned forwards and train step over a
grid of ranks with the optional int8 payload (:mod:`.gnn_dist`), NequIP's
Cartesian l<=2 irreps (:mod:`.irreps`), and GraphCast's multimesh
(:mod:`.icosahedron`, a numpy copy)."""
