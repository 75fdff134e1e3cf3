"""Rank functions for the port's data-parallel vocoder training tests
(``tests/test_torch_vocoder_training.py``), run by
``parallel.launch.run_local`` in spawned processes of a gloo group. They
import no JAX: a spawned rank imports this module by name."""

import torch

from fastspeech2_lightning_tpu_torch.parallel import batch_rows, make_layout, use_layout
from fastspeech2_lightning_tpu_torch.training import vocoder as pv


def _grads(module) -> dict:
    return {k: p.grad.detach().clone() for k, p in module.named_parameters()}


def _params(module) -> dict:
    return {k: p.detach().clone() for k, p in module.named_parameters()}


def vocoder_steps(rank: int, world: int, gen_cfg, disc_cfg, tc, audio, gen_sd, disc_sd,
                  batches, faults=("",)) -> dict:
    """For each fault of `faults`: D+G steps of a `world`-rank data group
    from the given weights, one a global batch of `batches`, each rank on
    its rows; the ranks' mean losses of every step, the (averaged) gradients
    of step 1 and the parameters after it. Fault "skip_g_average" leaves
    the generator's gradients this rank's own."""
    own = pv.average_gradients
    out = {}
    with use_layout(make_layout(1)):
        for fault in faults:
            st = pv.create_vocoder_state(gen_cfg, disc_cfg, tc, device="cpu")
            st.gen.load_state_dict({k: torch.as_tensor(v) for k, v in gen_sd.items()})
            st.disc.load_state_dict({k: torch.as_tensor(v) for k, v in disc_sd.items()})
            if fault == "skip_g_average":
                pv.average_gradients = lambda m: None if m is st.gen else own(m)
            step = pv.make_vocoder_train_step(gen_cfg, disc_cfg, tc, audio)
            losses, first = [], None
            try:
                for b in batches:
                    rows = {k: torch.from_numpy(v.copy()) for k, v in batch_rows(b).items()}
                    losses.append(pv._mean_losses(step(st, rows)))
                    if first is None:
                        first = dict(grads={"gen": _grads(st.gen), "disc": _grads(st.disc)},
                                     params={"gen": _params(st.gen), "disc": _params(st.disc)})
            finally:
                pv.average_gradients = own
            out[fault] = dict(losses=losses, **first)
    return out


def train_vocoder_rank(rank: int, world: int, config, tc, gen_cfg, disc_cfg, log_dir,
                       steps) -> list:
    """``train_vocoder(data_parallel=world)`` on the CPU in this process
    group, to each step count of `steps` in turn (each later run resumes);
    the step and the generator's weights after each."""
    out = []
    for max_steps in steps:
        st = pv.train_vocoder(config, train_config=tc, gen_config=gen_cfg, disc_config=disc_cfg,
                              log_dir=log_dir, max_steps=max_steps, data_parallel=world,
                              device="cpu")
        out.append({"step": st.step, "gen": _params(st.gen)})
    return out
