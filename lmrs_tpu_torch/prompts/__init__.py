"""L4 prompt system: map / system / reduce prompt triad.

Capability parity with the reference prompt layer (main.py:259-322 + prompts/
assets + reduce prompts in result_aggregator.py:404-498), with the resolution
precedence chain preserved (README.md:130-134):

* map prompt      — explicit template > ``--prompt-file`` > built-in default;
                    placeholder ``{transcript}`` (auto-appended with a warning
                    if a file omits it, main.py:274-277).
* system prompt   — explicit > file > None (main.py:160-167).
* reduce prompt   — explicit > file > role default; placeholder ``{summaries}``
                    (+ optional ``{metadata}`` / ``{num_summaries}``).

Divergence (deliberate): reduce-prompt placeholders are REALLY substituted —
the reference's defaults carry placeholders that are never ``.format()``-ed
(SURVEY.md §2.3 quirk 6).
"""

from __future__ import annotations

import logging
from pathlib import Path

logger = logging.getLogger("lmrs_torch.prompts")

_ASSET_DIR = Path(__file__).parent / "assets"

DEFAULT_MAP_PROMPT = """\
You are summarizing one section of a much longer transcript. The section is
annotated with [MM:SS] timestamps and a header describing where it falls in
the full recording.

Write a {summary_type} of the following transcript section. Keep every
concrete fact, decision, name, and number. When you mention a specific moment,
carry its timestamp through in [MM:SS] form. Do not add greetings,
introductions, or meta-commentary — output the summary content only.

Transcript section:
{transcript}
"""

DEFAULT_REDUCE_PROMPT = """\
You are combining {num_summaries} partial summaries of consecutive sections of
one long transcript into a single coherent summary.

Transcript metadata: {metadata}

Rules:
- Merge overlapping points; never repeat the same fact twice.
- Preserve chronological order and keep [MM:SS] / [HH:MM:SS] timestamps that
  mark important moments.
- Do not mention that the input was split into sections or summaries.
- Begin directly with the summary content. No greetings, no preamble, no
  closing remarks.

Partial summaries:
{summaries}
"""

DEFAULT_BATCH_REDUCE_PROMPT = """\
You are combining {num_summaries} partial summaries that cover ONE contiguous
portion of a longer transcript ({metadata}). Produce an intermediate summary
of just this portion: merge duplicates, keep chronological order, and retain
[MM:SS] timestamps for notable moments. Output only the summary content.

Partial summaries:
{summaries}
"""

DEFAULT_FINAL_REDUCE_PROMPT = """\
The following are intermediate summaries, each covering a consecutive portion
of one long transcript ({metadata}). Weave them into one final, coherent
summary of the entire recording: chronological, non-repetitive, preserving
[MM:SS] timestamps on key moments. Begin directly with the summary — no
greeting, no preamble.

Intermediate summaries:
{summaries}
"""

DEFAULT_SYSTEM_PROMPT = None  # reference default: no system prompt (main.py:160-167)


def load_prompt_file(path: str | Path) -> str | None:
    """Read a prompt file; None (with a log line) on failure — file errors are
    never fatal mid-pipeline (main.py:280-282,317-319)."""
    try:
        return Path(path).read_text(encoding="utf-8")
    except OSError as e:
        logger.error("could not read prompt file %s: %s", path, e)
        return None


def resolve_map_prompt(
    template: str | None = None, prompt_file: str | None = None
) -> str:
    """Map-prompt precedence chain (main.py:155-157,259-300)."""
    if template is not None:
        text = template
    elif prompt_file:
        text = load_prompt_file(prompt_file) or DEFAULT_MAP_PROMPT
    else:
        text = DEFAULT_MAP_PROMPT
    if "{transcript}" not in text:
        logger.warning("map prompt lacks {transcript} placeholder; appending it")
        text = text.rstrip() + "\n\n{transcript}"
    return text


def resolve_system_prompt(
    system_prompt: str | None = None, system_prompt_file: str | None = None
) -> str | None:
    """System-prompt precedence chain (main.py:160-167,302-322)."""
    if system_prompt is not None:
        return system_prompt
    if system_prompt_file:
        return load_prompt_file(system_prompt_file)
    return DEFAULT_SYSTEM_PROMPT


def resolve_reduce_prompt(
    template: str | None = None, prompt_file: str | None = None
) -> str | None:
    """Reduce-prompt precedence; None means role defaults (main.py:209-217)."""
    if template is not None:
        return template
    if prompt_file:
        return load_prompt_file(prompt_file)
    return None


def builtin_prompt(name: str) -> str:
    """Load a shipped prompt asset by stem name (e.g. "analytical_map")."""
    path = _ASSET_DIR / f"{name}.txt"
    return path.read_text(encoding="utf-8")


def list_builtin_prompts() -> list[str]:
    return sorted(p.stem for p in _ASSET_DIR.glob("*.txt"))


def shared_prefix_chars(template: str, *varying: str, **constant) -> int | None:
    """Length of the prompt prefix SHARED by every request built from
    ``template``: substitute the constant placeholders, then cut at the
    first occurrence of any per-request (``varying``) placeholder.  Feeds
    ``GenerationRequest.cache_prefix`` (the prefix cache caps page adoption
    there, so per-request bodies never bloat the radix tree).  None when
    the template has no varying placeholder (the whole prompt is shared)."""
    head = safe_format(template, **constant)
    cuts = [c for c in (head.find("{" + v + "}") for v in varying) if c >= 0]
    return min(cuts) if cuts else None


def safe_format(template: str, **kw) -> str:
    """Substitute only known ``{placeholder}`` names; leave every other brace
    untouched.  ``str.format`` would crash on literal braces in user prompt
    files (e.g. JSON examples), so all prompt substitution routes through
    this.

    Single-pass over the TEMPLATE only: substituted values are never
    re-scanned, so transcript/summary content containing a literal
    ``{placeholder}`` cannot trigger a second expansion (template injection).
    """
    import re as _re

    if not kw:
        return template
    pattern = _re.compile("|".join("\\{" + _re.escape(k) + "\\}" for k in kw))
    return pattern.sub(lambda m: str(kw[m.group(0)[1:-1]]), template)
