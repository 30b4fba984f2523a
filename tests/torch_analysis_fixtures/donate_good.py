"""The fixed twin of donate_bad.py: the parity check gives the control
run fresh copies of the restored state (``.clone()``,
``copy.deepcopy``) before the donating run, loops rebind their donated
operands, and no argument slot is both donated and read.  donatecheck
must report nothing here.
"""
import copy


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
    params_ctl = {k: v.clone() for k, v in params_h.items()}
    opt_ctl = copy.deepcopy(opt_h)
    resharded = train(model, batches, params=params_h, opt_state=opt_h,
                      donate=True)
    control = train(model, batches, params=params_ctl, opt_state=opt_ctl)
    return resharded, control


def loop_rebinds(model, params, opt_state, batches):
    step_fn = build_train_step(model, donate=True)
    for batch in batches:
        params, opt_state = step_fn(params, opt_state, batch)
    return params, opt_state


def clone_breaks_the_chain(model, params, opt_state, batch):
    mine = params.clone()
    step_fn = build_train_step(model, donate=True)
    step_fn(mine, opt_state.clone(), batch)
    return params, opt_state


def passes_its_flag(model, params, opt_state, batch, donate=False):
    step_fn = build_train_step(model, donate=donate)
    params, opt_state = step_fn(params, opt_state, batch)
    return params, opt_state
