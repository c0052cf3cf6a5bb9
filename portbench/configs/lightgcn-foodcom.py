"""FLOPs of one LightGCN training step, from the shapes: the projection of
the whole text table (its backward to the weight and to the trainable
table, two products of the same size) and the SpMM products of the
propagation with their backward (one each). Elementwise work, gathers and
the optimizer are not counted."""

from portbench.reference import plain


def graphs(data):
    nu, ni = data["n_users"], data["n_items"]
    return {nu + ni: plain.nnz(data["train_u"], data["train_i"] + nu,
                               nu + ni)}


def step_flops(shapes, graphs, batch, mc):
    d = mc["embedding_size"]
    nu, ni = shapes["n_users"], shapes["n_items"]
    projection = 2 * ni * shapes["txt_dim"] * d
    spmm = 2 * d * mc["n_layers"] * graphs[nu + ni]
    return 3 * projection + 2 * spmm
