"""The reshard_check bug in the port's form, reduced: ``train`` updates
the params and moments it is given in place (``donate=True``), and the
parity check then hands the same restored tensors to the control run,
which starts from what the first run wrote.  donatecheck must flag every
marked line (DON001/DON002/DON003); the fixed twin is donate_good.py.
"""
from repro_torch.optim.adamw import tree_map


def adamw_update(grads, state, params, lr, *, donate=False):
    def one(p, g, m):
        m_new = 0.9 * m + g
        p_new = p - lr * m_new
        if not donate:
            return p_new, m_new
        p.copy_(p_new)
        m.copy_(m_new)
        return p, m

    out = {k: one(params[k], grads[k], state["m"][k]) for k in params}
    return ({k: o[0] for k, o in out.items()},
            {"m": {k: o[1] for k, o in out.items()}})


def build_train_step(model, *, donate=False):
    def step(params, opt_state, batch):
        grads = model.grads(params, batch)
        return adamw_update(grads, opt_state, params, 1e-3, donate=donate)
    return step


def train(model, batches, *, params, opt_state, donate=False):
    step_fn = build_train_step(model, donate=donate)
    for batch in batches:
        params, opt_state = step_fn(params, opt_state, batch)
    return params


def run_place(model, ckpt, batches):
    params_h, opt_h = ckpt.restore()
    # the resharded run updates the restored tensors in place ...
    resharded = train(model, batches, params=params_h, opt_state=opt_h,
                      donate=True)
    # ... and the control run starts from them: DON001 x2
    control = train(model, batches, params=params_h, opt_state=opt_h)
    return resharded, control


def loop_never_rebinds(model, params, opt_state, batches):
    step_fn = build_train_step(model, donate=True)
    for batch in batches:
        # DON001 x2: the next iteration steps from what this one wrote
        out = step_fn(params, opt_state, batch)
    return out


def donated_and_read_slot(model, params, opt_state, batch):
    step_fn = build_train_step(model, donate=True)
    # DON002: params is both donated (arg 0) and read (inside arg 2)
    return step_fn(params, opt_state, (batch, params))


def unverifiable_flag(model, flag):
    # DON003: the donation contract is not a literal
    return build_train_step(model, donate=flag)


def detach_and_to_alias(model, params, opt_state, batch):
    view = params.detach()
    moved = opt_state.to("cpu")
    step_fn = build_train_step(model, donate=True)
    step_fn(view, moved, batch)
    # DON001 x2: .detach() and .to() hand back the same tensors
    return params, opt_state


def tree_map_aliases(model, params, opt_state, batch):
    moved = tree_map(lambda t: t.to("cpu"), params)
    step_fn = build_train_step(model, donate=True)
    moved, opt_state = step_fn(moved, opt_state, batch)
    # DON001: a tree map of .to() hands back the same tensors
    return params
