"""FLOPs of one CIKM_Model training step, from the shapes: the matrix
products and the SpMM products of the forward, with each product's
backward (two products of the same size for a matrix product whose two
inputs train, one for an SpMM, whose graph does not). Elementwise work,
gathers, softmax and the optimizer are not counted."""

from portbench.reference import plain


def graphs(data):
    """{nodes: edges} of the model's two graphs."""
    nu, ni, ning = data["n_users"], data["n_items"], data["n_ingredients"]
    ri = data["ri"]
    return {nu + ni: plain.nnz(data["train_u"], data["train_i"] + nu, nu + ni),
            ni + ning: plain.nnz(ri[:, 1] + ni, ri[:, 0], ni + ning)}


def step_flops(shapes, graphs, batch, mc):
    d, h = mc["embedding_size"], mc["num_attention_heads"]
    L = plain.MAX_INGRE_LEN
    dh = d // h
    b2 = 2 * batch  # positives and negatives
    t = b2 * L      # ingredient tokens
    nu, ni = shapes["n_users"], shapes["n_items"]
    nnz_ui = graphs[nu + ni]
    nnz_ri = graphs[ni + shapes["n_ingredients"]]
    spmm = 2 * d * (mc["n_layers"] * nnz_ri + mc["ui_layers"] * nnz_ui)
    encoder = mc["num_hidden_layers"] * (
        2 * t * d * 3 * d            # in_proj
        + 2 * 2 * b2 * h * L * L * dh  # logits, attention @ v
        + 2 * t * d * d              # out_proj
        + 2 * 2 * t * d * 4 * d)     # feed-forward
    queries = 2 * b2 * (shapes["img_dim"] + shapes["txt_dim"]) * d
    targets = 2 * 2 * 2 * b2 * h * 2 * L * dh  # two attentions, 2 x 20
    health = 2 * b2 * (d * d + d * shapes["n_health"])
    return 3 * (encoder + queries + targets + health) + 2 * spmm
