"""One rank of the port's data- and tensor-parallel tests
(tests/test_torch_parallel*.py, tests/test_torch_tp*.py, tests/test_torch_sp.py).

    python tests/_torch_parallel_worker.py RANK WORLD STORE JOB

Joins a gloo process group of WORLD ranks through the file store STORE
(`parallel.multihost.maybe_initialize_distributed`, device='cpu'), then runs
each task of the JSON file JOB in order and writes its results as .npz files
into the task's ``out`` directory (the full state from rank 0, per-rank
counts from every rank). Imports torch and the port only, never JAX: the
test process holds the results against JAX or against the port's single
device. The helpers that build a model and run a trainer's steps are shared
with the tests, so both sides make them the same way.

A task with ``tp = [data, model]`` shards its model over that
(`parallel.tp.make_2d_mesh`, `shard_module_tp`) and trains it on the mesh;
its kinds beyond the trainer's steps: ``grads`` (one loss and backward on
the global batch of its first step, no trainer), ``sample`` and ``paths``
(the sharded set of a model with a duration predictor and frequency
tokens), ``fsdp`` (the error a trainer with FSDP on the mesh raises).

A task with ``sp = [data, seq]`` trains on the (data, seq) mesh
(`parallel.sp.make_seq_mesh`; with ``trainer_builds_mesh`` the trainer
builds it from ``sequence_parallel``); its kinds beyond the steps:
``sp_grads`` (one loss and backward of the routed model on its rows, the
grads summed over every rank, no trainer) and ``sp_errors`` (the errors of
an indivisible batch and of a shard shorter than the conv's halo).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from e2_tts_tpu_torch.models import blocks as blocks_module        # noqa: E402
from e2_tts_tpu_torch.models import e2tts as e2tts_module          # noqa: E402
from e2_tts_tpu_torch.models.duration import DurationPredictor     # noqa: E402
from e2_tts_tpu_torch.models.e2tts import E2TTS                    # noqa: E402
from e2_tts_tpu_torch.models import transformer as transformer_module  # noqa: E402
from e2_tts_tpu_torch.parallel import sp as sp_module               # noqa: E402
from e2_tts_tpu_torch.parallel import tp as tp_module               # noqa: E402
from e2_tts_tpu_torch.parallel.fsdp import gather_full, local      # noqa: E402
from e2_tts_tpu_torch.training import trainer as trainer_module    # noqa: E402
from e2_tts_tpu_torch.training.trainer import E2Trainer            # noqa: E402

LR = 1e-3
EMA_KW = dict(update_after_step=0, update_every=1)


def build_model(config: dict, *, seed: int = 0, velocity_weight: float = 0.0,
                jax_state: str | None = None, **model_kw) -> E2TTS:
    """The CPU E2TTS of ``config`` (and ``model_kw``): the JAX start state
    from the .npz ``jax_state`` when given, else seeded weights, each
    perturbed by 0.02 N(0, 1) (no zero-initialised branch stays dead)."""
    model = E2TTS(transformer=dict(config), velocity_consistency_weight=velocity_weight,
                  generator=torch.Generator().manual_seed(seed), device='cpu', **model_kw)
    if jax_state is None:
        return _perturbed(model, seed)
    from e2_tts_tpu_torch.convert import load_jax_params
    with np.load(jax_state) as flat:
        load_jax_params(model, dict(flat))
    return model


def build_predictor(config: dict, *, seed: int = 0) -> DurationPredictor:
    """A CPU DurationPredictor of ``config`` from seeded weights, perturbed
    as `build_model`'s."""
    return _perturbed(DurationPredictor(transformer=dict(config), device='cpu',
                                        generator=torch.Generator().manual_seed(seed)), seed)


def _perturbed(module, seed: int):
    noise = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=noise))
    return module


def make_trainer(model, **kw) -> E2Trainer:
    kw = dict(dict(learning_rate=LR, num_warmup_steps=0, total_steps=100, ema_kwargs=EMA_KW),
              **kw)
    return E2Trainer(model, **kw)


def tp_full(module):
    """A function of (tensor, parameter of ``module``) giving the tensor's
    full value when ``module`` is tensor-parallel and the parameter one of
    its pieces (a collective), else the tensor."""
    layouts, axis = tp_module.param_layouts(module), tp_module.tp_axis(module)
    return lambda t, p: (tp_module.full_tensor(t, layouts[p], axis) if p in layouts
                         else t.detach())


def full_state(trainer: E2Trainer) -> dict:
    """Parameters, EMA weights, ADOPT's moments and the accumulator's mean
    grads as name -> full f32 numpy array, with the EMA's and the
    accumulator's counters (a collective under FSDP and TP: every rank calls
    it)."""
    out = {}
    params = dict(trainer.model.named_parameters())
    ema = dict(trainer.ema.ema_model.named_parameters())
    full, ema_full = tp_full(trainer.model), tp_full(trainer.ema.ema_model)
    for name, p in params.items():
        out[f'param.{name}'] = full(p, p)
        out[f'ema.{name}'] = ema_full(ema[name], ema[name])
        state = trainer.optimizer.state.get(p, {})
        for key in ('m', 'v'):
            if key in state:
                out[f'{key}.{name}'] = full(state[key], p)
    if trainer.train_duration_predictor:
        out.update({f'dp_param.{name}': p
                    for name, p in trainer.duration_predictor.named_parameters()})
    acc = trainer.accumulator
    if acc is not None:
        out.update({f'acc.{i}': full(g, p)
                    for i, (g, p) in enumerate(zip(acc.grads, params.values()))})
    full = gather_full({k: v.detach() for k, v in out.items()})
    full = {k: v.float().numpy().copy() for k, v in full.items()}   # not views of live tensors
    full.update(ema_step=np.asarray(trainer.ema.step), ema_initted=np.asarray(trainer.ema.initted))
    if acc is not None:
        full['acc_step'] = np.asarray(acc.mini_step)
    return full


def run_steps(trainer: E2Trainer, steps: list[dict]) -> list[float]:
    """``trainer.train_step`` on each step's global batch (``mel``, ``lens``,
    ``text``, ``drop``, and the draws ``times`` / ``noise`` /
    ``rand_span_mask`` when given), after the duration predictor's step when
    the trainer has one; returns the losses (the predictor's before each)."""
    losses = []
    for step in steps:
        if trainer.duration_predictor is not None:
            losses.append(float(trainer.duration_step(step['mel'], step['lens'])))
        draws = {k: torch.as_tensor(step[k]) for k in ('times', 'noise', 'rand_span_mask')
                 if k in step}
        loss, _, _ = trainer.train_step(step['mel'], step['lens'], step['text'],
                                        drop_text_cond=bool(step['drop']), **draws)
        losses.append(float(loss))
    return losses


def local_bytes(trainer: E2Trainer) -> dict:
    """Bytes this rank holds of the parameters, the EMA copy and ADOPT's
    moments."""
    params = list(trainer.model.parameters())
    nbytes = lambda ts: sum(local(t).numel() * local(t).element_size() for t in ts)
    moments = [t for p in params for k, t in trainer.optimizer.state.get(p, {}).items()
               if k in ('m', 'v')]
    return dict(params=nbytes(params), ema=nbytes(trainer.ema.ema_model.parameters()),
                adopt=nbytes(moments))


def toy_dataset(count: int = 8):
    """``count`` seeded (100, frames) mels of ragged lengths with texts, as
    `E2Trainer.train` takes them."""
    from e2_tts_tpu_torch.training.data import ArrayDataset
    rng = np.random.default_rng(11)
    return ArrayDataset([rng.standard_normal((100, int(n))).astype(np.float32)
                         for n in rng.integers(20, 48, count)],
                        [' '.join(['ab', 'cd', 'efg'][: 1 + i % 3]) for i in range(count)])


def run_train(trainer: E2Trainer, epochs: int = 2, batch_size: int = 4) -> dict:
    """`E2Trainer.train` over `toy_dataset`, a checkpoint every step: the
    losses it returns and the final state."""
    history = trainer.train(toy_dataset(), epochs=epochs, batch_size=batch_size, save_step=1)
    return dict(losses=np.asarray([loss for _, loss in history]),
                **{f'final.{k}': v for k, v in full_state(trainer).items()})


def _steps(path: str) -> list[dict]:
    with np.load(path) as f:
        n = int(f['n'])
        return [{k[len(f'{i}.'):]: f[k] for k in f.files if k.startswith(f'{i}.')}
                for i in range(n)]


def wait_for(path: str, timeout: float = 120.0):
    """Until ``path`` exists (a file the test process writes whole while the
    ranks run: a checkpoint, the JAX weights)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f'{path} did not appear within {timeout:.0f} s')
        time.sleep(0.1)


def run_task(task: dict, rank: int, world: int):
    """Build, run and record one task (see the module docstring)."""
    out = task['out']
    steps = _steps(task['steps']) if task.get('steps') else []
    kw = dict(task.get('trainer', {}))
    if task.get('resume_from'):
        kw['checkpoint_path'] = task['resume_from']
    elif task.get('save_to'):
        kw['checkpoint_path'] = task['save_to']
    fault = task.get('fault')
    restore = []
    patch = lambda obj, name, value: (restore.append(
        lambda old=getattr(obj, name): setattr(obj, name, old)), setattr(obj, name, value))
    if fault == 'hash_h0_zero':    # every model rank draws the attention bits of heads [0, H/T)
        attention = blocks_module.attention_packed
        patch(blocks_module, 'attention_packed',
              lambda *a, **o: attention(*a, **dict(o, hash_h0=0)))
    elif fault == 'proj_in_rows':  # proj_in cut as one block of rows: value or gate rows a rank
        patch(tp_module, '_RULES', tuple(
            (cls, names, param, (0, 1) if param.startswith('proj_in') else layout)
            for cls, names, param, layout in tp_module._RULES))
    elif fault == 'gate_grad':     # the value-head gate's grads left as each rank's own rows'
        patch(trainer_module, 'sum_shared_grads_', lambda params, axis: None)
    elif fault == 'offset0':       # every rank claims the batch's first rows
        orig = E2Trainer._rows

        def rows(self, *arrays):
            shard, place = orig(self, *arrays)
            return shard, dict(place, batch_offset=0)
        E2Trainer._rows = rows
        restore.append(lambda: setattr(E2Trainer, '_rows', orig))
    elif fault == 'offsets0':      # every ring block draws the bits of rows and columns from 0
        for name in ('block_forward', 'block_backward'):
            block = getattr(sp_module, name)
            patch(sp_module, name, lambda *a, _block=block, hash_kw, **o: _block(
                *a, hash_kw=dict(hash_kw, hash_r0=0, hash_c0=0), **o))
    elif fault == 'no_halo':       # each shard's conv zero-padded, as a sequence of its own
        patch(sp_module, 'halo_pad', lambda x, seq, width: torch.nn.functional.pad(
            x, (0, 0, width, width)))
    elif fault == 'local_rotary':  # every shard's rotary tables from position 0
        tables, size = transformer_module.rotary_tables, task['sp'][1]
        patch(transformer_module, 'rotary_tables', lambda n, dh, device=None: tuple(
            t[:n // size].repeat(size, 1) for t in tables(n, dh, device=device)))
    elif fault == 'local_span':    # each shard's error over its own span count
        mse = e2tts_module.masked_mse
        patch(e2tts_module, 'masked_mse', lambda pred, target, span, count=None: mse(
            pred, target, span))
    elif fault == 'rank_mean':     # each rank's loss is its own span's mean
        orig_count = e2tts_module.global_span_count
        e2tts_module.global_span_count = lambda span, group=None: span.float().sum() * world
        restore.append(lambda: setattr(e2tts_module, 'global_span_count', orig_count))

    counts, norms = [], []
    count_fn, clip_fn = e2tts_module.global_span_count, trainer_module.clip_by_global_norm_

    def counting(span, group=None):
        counts.append(float(span.float().sum()))
        return count_fn(span, group)

    def clipping(grads, max_norm, **kw):
        norm = clip_fn(grads, max_norm, **kw)
        norms.append(float(norm))
        return norm
    e2tts_module.global_span_count = counting
    trainer_module.clip_by_global_norm_ = clipping
    restore.append(lambda: setattr(e2tts_module, 'global_span_count', count_fn))
    restore.append(lambda: setattr(trainer_module, 'clip_by_global_norm_', clip_fn))
    try:
        if task['kind'] in ('grads', 'sample', 'paths', 'fsdp'):
            run_tp_task(task, rank, steps)
            return
        if task['kind'] in ('sp_grads', 'sp_errors'):
            run_sp_task(task, rank, steps)
            return
        model = build_model(task['config'], seed=task.get('seed', 0),
                            velocity_weight=task.get('velocity_weight', 0.0),
                            jax_state=task.get('jax_state'), **task.get('model_kw', {}))
        if task.get('dp_config'):
            kw.update(duration_predictor=build_predictor(task['dp_config'], seed=2),
                      train_duration_predictor=True)
        if task.get('tp'):
            kw['mesh'] = tp_module.make_2d_mesh(*task['tp'])
            tp_module.shard_module_tp(model, kw['mesh'])
        if task.get('sp'):
            data, seq = task['sp']
            kw['sequence_parallel'] = seq
            if not task.get('trainer_builds_mesh'):
                kw['mesh'] = sp_module.make_seq_mesh(seq, data)
        trainer = make_trainer(model, param_sharding=task['sharding'], **kw)
        record = {}
        if task.get('resume_from'):
            wait_for(os.path.join(task['resume_from'], 'checkpoint.pt'))
            record['resumed_step'] = trainer.resume()
            record.update({f'resumed.{k}': v for k, v in full_state(trainer).items()})
        if task['kind'] == 'train':
            record.update(run_train(trainer))
        else:
            split = task.get('save_after')
            losses = []
            for i, step in enumerate(steps):
                losses += run_steps(trainer, [step])
                if task.get('every_step'):
                    record.update({f'step{i}.{k}': v for k, v in full_state(trainer).items()})
                if split is not None and i + 1 == split:
                    trainer.save_checkpoint(i + 1)
                    record.update({f'saved.{k}': v for k, v in full_state(trainer).items()})
            record['losses'] = np.asarray(losses)
            record.update({f'final.{k}': v for k, v in full_state(trainer).items()})
        np.savez(os.path.join(out, f'rank{rank}.npz'), counts=np.asarray(counts),
                 norms=np.asarray(norms), **local_bytes(trainer))
        if rank == 0:
            np.savez(os.path.join(out, 'result.npz'), **record)
    finally:
        for undo in reversed(restore):
            undo()


SAMPLE_STEPS = 4


def sample_model(config: dict, dp_config: dict):
    """The E2TTS of ``config`` with a duration predictor of ``dp_config``
    (seeded, perturbed) for the sampler's checks."""
    model = E2TTS(transformer=dict(config), duration_predictor=dict(transformer=dict(dp_config)),
                  generator=torch.Generator().manual_seed(3), device='cpu')
    return _perturbed(model, 3).eval()


def sample_run(model, prompt: np.ndarray, text: list[str], duration: int) -> dict:
    """A midpoint sample of ``SAMPLE_STEPS`` steps from a seeded generator,
    and the duration predictor's estimate for the prompt."""
    cond = torch.from_numpy(prompt)
    out = model.sample(cond, text=text, duration=duration, steps=SAMPLE_STEPS,
                       generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        dur = model.duration_predictor(cond, text=text, return_loss=False)
    return dict(sample=out.float().numpy(), duration=dur.float().numpy())


def run_tp_task(task: dict, rank: int, steps: list[dict]):
    """A tensor-parallel task without a trainer: ``grads`` (the global
    loss of the first step and every full grad, summed over the data axis),
    ``sample`` (every rank's sample and duration estimate), ``paths`` (the
    sharded set) or ``fsdp`` (what a trainer with FSDP on the mesh
    raises)."""
    out = task['out']
    mesh = tp_module.make_2d_mesh(*task['tp'])
    if task['kind'] == 'fsdp':
        model = tp_module.shard_module_tp(build_model(task['config']), mesh)
        try:
            make_trainer(model, mesh=mesh, param_sharding='fsdp')
            error = 'none'
        except Exception as e:        # recorded for the test to read
            error = f'{type(e).__name__}: {e}'
        if rank == 0:
            np.savez(os.path.join(out, 'result.npz'), error=np.asarray(error))
        return
    if task['kind'] == 'paths':
        model = E2TTS(transformer=dict(task['config']), num_freq_tokens=2,
                      duration_predictor=dict(transformer=dict(task['dp_config'])),
                      device='cpu')
        tp_module.shard_module_tp(model, mesh)
        if rank == 0:
            np.savez(os.path.join(out, 'result.npz'), paths=np.asarray(model._tp_sharded_paths))
        return
    if task['kind'] == 'sample':
        model = tp_module.shard_module_tp(sample_model(task['config'], task['dp_config']), mesh)
        np.savez(os.path.join(out, f'rank{rank}.npz'),
                 **sample_run(model, np.asarray(task['prompt'], np.float32), task['text'],
                              task['duration']))
        return
    wait_for(task['jax_state'])
    model = tp_module.shard_module_tp(build_model(task['config'], jax_state=task['jax_state']),
                                      mesh)
    step = steps[0]
    data = mesh[tp_module.DATA_AXIS]
    batch = len(step['mel'])
    start, stop = trainer_module.batch_rows(batch, data)
    rows = {k: torch.as_tensor(v[start:stop]) for k, v in step.items() if k != 'drop'}
    out_ = model(rows['mel'], text=rows['text'].long(), lens=rows['lens'].long(),
                 times=rows['times'], noise=rows['noise'], rand_span_mask=rows['rand_span_mask'],
                 drop_text_cond=bool(step['drop']), batch_offset=start, global_batch=batch)
    out_.loss.backward()
    tp_module.sum_shared_grads_(tp_module.shared_params(model), tp_module.tp_axis(model))
    import torch.distributed as dist
    loss = out_.loss.detach().clone()
    dist.all_reduce(loss, group=data.get_group())
    full = tp_full(model)
    grads = {}
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        dist.all_reduce(g, group=data.get_group())
        grads[f'grad.{name}'] = full(g, p).numpy()
    if rank == 0:
        np.savez(os.path.join(out, 'result.npz'), loss=loss.numpy(), **grads)


def forward_grads(model, step: dict, mesh=None) -> dict:
    """One loss and backward of ``model`` on the global batch ``step``
    (``mel``, ``lens``, ``text``, ``drop`` and the draws ``times`` /
    ``noise`` / ``rand_span_mask`` when given; dropout seeds from a
    generator seeded 9): on one device without ``mesh``, else routed over
    the (data, seq) ``mesh`` on this rank's rows, the grads summed over
    every rank (a collective). Returns the loss and every grad as numpy."""
    import torch.distributed as dist
    model.train()
    place, rows = {}, slice(None)
    if mesh is not None:
        sp_module.enable_sequence_parallel(model, mesh)
        start, stop = trainer_module.batch_rows(len(step['mel']), mesh[sp_module.DATA_AXIS])
        place, rows = dict(batch_offset=start, global_batch=len(step['mel'])), slice(start, stop)
    draws = {k: torch.tensor(step[k][rows]) for k in ('times', 'noise', 'rand_span_mask')
             if k in step}
    out = model(torch.as_tensor(step['mel'][rows]), text=torch.as_tensor(step['text'][rows]).long(),
                lens=torch.as_tensor(step['lens'][rows]).long(), drop_text_cond=bool(step['drop']),
                generator=torch.Generator().manual_seed(9), **draws, **place)
    out.loss.backward()
    loss = out.loss.detach().clone()
    grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
             for name, p in model.named_parameters()}
    if mesh is not None:
        dist.all_reduce(loss, group=mesh[sp_module.DATA_AXIS].get_group())
        for g in grads.values():
            dist.all_reduce(g)
    return dict(loss=loss.numpy(), **{f'grad.{k}': g.numpy() for k, g in grads.items()})


def run_sp_task(task: dict, rank: int, steps: list[dict]):
    """A sequence-parallel task without a trainer's steps: ``sp_grads``
    (`forward_grads` of the routed model, from the JAX weights when the
    task names them) or ``sp_errors`` (the messages of an indivisible
    batch through the trainer and of a shard shorter than the halo)."""
    out = task['out']
    data, seq = task['sp']
    mesh = sp_module.make_seq_mesh(seq, data)
    if task['kind'] == 'sp_grads':
        if task.get('jax_state'):
            wait_for(task['jax_state'])
        model = build_model(task['config'], jax_state=task.get('jax_state'),
                            **task.get('model_kw', {}))
        result = forward_grads(model, steps[0], mesh)
        if rank == 0:
            np.savez(os.path.join(out, 'result.npz'), **result)
        return
    errors = {}
    trainer = make_trainer(build_model(task['config']), mesh=mesh)
    step = steps[0]
    try:
        run_steps(trainer, [dict(step, mel=step['mel'][:, 1:])])    # frames + registers odd
    except ValueError as e:
        errors['batch'] = str(e)
    model = build_model(dict(task['config'], kernel_size=31))
    try:                                                           # 12 rows a shard, halo 15
        forward_grads(model, step, mesh)
    except ValueError as e:
        errors['halo'] = str(e)
    if rank == 0:
        np.savez(os.path.join(out, 'result.npz'), **{k: np.asarray(v) for k, v in errors.items()})


def write_steps(path: str, steps: list[dict]) -> str:
    """``steps`` (dicts of arrays) as the .npz a task's ``steps`` names."""
    flat = {f'{i}.{k}': np.asarray(v) for i, step in enumerate(steps) for k, v in step.items()}
    np.savez(path, n=len(steps), **flat)
    return path


class Ranks:
    """``world`` gloo ranks running ``tasks``, each this file in its own
    process, over a file store under ``tmp_path`` (no port to share between
    test workers). `join` waits for all of them until ``timeout`` seconds
    after the start; on expiry or a failure it kills every rank and raises
    with their output, so a hung rendezvous fails its test and never holds
    up the run."""

    def __init__(self, world: int, tasks: list[dict], tmp_path, timeout: float = 150.0):
        job = os.path.join(tmp_path, 'job.json')
        with open(job, 'w') as f:
            json.dump(tasks, f)
        env = dict(os.environ, OMP_NUM_THREADS='1')
        env.pop('XLA_FLAGS', None)
        self.timeout = timeout
        self.deadline = time.monotonic() + timeout
        self.logs = [open(os.path.join(tmp_path, f'rank{r}.log'), 'w+') for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world),
             os.path.join(tmp_path, 'store'), job], stdout=log, stderr=subprocess.STDOUT,
            env=env) for r, log in enumerate(self.logs)]

    def join(self) -> None:
        try:
            for proc in self.procs:
                proc.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for proc in self.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        outputs = []
        for log in self.logs:
            log.seek(0)
            outputs.append(log.read())
            log.close()
        codes = [proc.returncode for proc in self.procs]
        if any(codes):
            raise RuntimeError(
                f'ranks exited with {codes} (a killed rank: the {self.timeout:.0f}-s limit)\n'
                + '\n'.join(f'--- rank {r}:\n{out[-3000:]}' for r, out in enumerate(outputs)))


def main():
    rank, world, store, job = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    from e2_tts_tpu_torch.parallel.multihost import maybe_initialize_distributed
    import torch.distributed as dist
    assert maybe_initialize_distributed(init_method=f'file://{store}', world_size=world,
                                        rank=rank, device='cpu', timeout=120)
    with open(job) as f:
        tasks = json.load(f)
    for task in tasks:
        os.makedirs(task['out'], exist_ok=True)
        start = time.perf_counter()
        run_task(task, rank, world)
        dist.barrier()
        print(f"task {os.path.basename(task['out'])}: {time.perf_counter() - start:.1f} s",
              flush=True)
    dist.destroy_process_group()


if __name__ == '__main__':
    main()
