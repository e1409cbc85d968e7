"""Graph neural networks: the single-device GraphCast, GAT, EGNN and NequIP
forwards (:mod:`.gnn`), their 2D-partitioned forwards and train step over a
grid of ranks with the optional int8 payload (:mod:`.gnn_dist`), NequIP's
Cartesian l<=2 irreps (:mod:`.irreps`), and GraphCast's multimesh
(:mod:`.icosahedron`, a numpy copy); and the decoder-only transformer
family, dense, GQA/MQA, MLA and MoE, with its KV cache and decode step
(:mod:`.transformer`); and the AutoInt recommender over a fused embedding
table (:mod:`.recsys`)."""
