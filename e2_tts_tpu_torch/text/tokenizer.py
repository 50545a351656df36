"""Host-side text tokenizers (counterpart of e2_tts_tpu/text/tokenizer.py).

Tokenization is string processing: it stays on the host and produces padded
int32 id arrays (pad value -1).
"""

from __future__ import annotations

import numpy as np
import torch

from e2_tts_tpu_torch.utils.helpers import exists


def pad_id_lists(id_lists: list[np.ndarray], padding_value: int = -1,
                 length: int | None = None) -> np.ndarray:
    """Right-pad a ragged list of 1-D int arrays into (b, nt)."""
    if not exists(length):
        length = max((len(t) for t in id_lists), default=0)
    out = np.full((len(id_lists), length), padding_value, dtype=np.int32)
    for i, ids in enumerate(id_lists):
        n = min(len(ids), length)
        out[i, :n] = ids[:n]
    return out


def list_str_to_ids(texts: list[str], padding_value: int = -1,
                    length: int | None = None) -> np.ndarray:
    """UTF-8 byte tokenizer ('char_utf8'): one id per byte, padded with -1."""
    id_lists = [np.frombuffer(t.encode('utf-8'), dtype=np.uint8).astype(np.int32)
                for t in texts]
    return pad_id_lists(id_lists, padding_value, length)


def get_g2p_en_encode():
    """The 'phoneme_en' tokenizer: g2p_en phonemes, then 17 extended
    punctuation ids after the phoneme vocabulary, as in the JAX package.
    Returns ``(encode, vocab size)``; raises ImportError without the
    optional g2p_en package."""
    try:
        from g2p_en import G2p
    except ImportError as e:
        raise ImportError("the 'phoneme_en' tokenizer requires the optional g2p_en package") \
            from e

    g2p = G2p()
    phoneme_to_index = g2p.p2idx
    num_phonemes = len(phoneme_to_index)
    extended_chars = [' ', ',', '.', '-', '!', '?', "'", '"', '...', '..', '. .', '. . .',
                      '. . . .', '. . . . .', '. ...', '... .', '.. ..']
    vocab = {**phoneme_to_index,
             **{p: num_phonemes + i for i, p in enumerate(extended_chars)}}

    def encode(texts: list[str], padding_value: int = -1) -> np.ndarray:
        id_lists = [np.array([vocab[p] for p in g2p(t)], dtype=np.int32) for t in texts]
        return pad_id_lists(id_lists, padding_value)

    return encode, num_phonemes + len(extended_chars)


def resolve_tokenizer(tokenizer, text_num_embeds=None):
    """Resolve a tokenizer spec ('char_utf8' | 'phoneme_en' | callable) into
    (encode_fn, vocab_size)."""
    if callable(tokenizer):
        assert exists(text_num_embeds), \
            '`text_num_embeds` must be given if supplying your own tokenizer encode function'
        return tokenizer, text_num_embeds
    if tokenizer == 'char_utf8':
        return list_str_to_ids, 256
    if tokenizer == 'phoneme_en':
        return get_g2p_en_encode()
    raise ValueError(f'unknown tokenizer string {tokenizer}')


def tokenize_batch(tokenizer, text, batch: int, device) -> torch.Tensor | None:
    """``text`` (a list of strings, ids ``(b, nt)`` or None) as a long id
    tensor on ``device``; raises unless it has ``batch`` rows."""
    if isinstance(text, list):
        text = torch.as_tensor(tokenizer(text), dtype=torch.long, device=device)
    if exists(text) and text.shape[0] != batch:
        raise ValueError(f'got {text.shape[0]} texts for a batch of {batch} audio samples')
    return text
