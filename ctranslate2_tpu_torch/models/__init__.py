"""Model loading and spec layer, plus the reference's ``ctranslate2.models``
namespace for the models that are not a Translator or a Generator
(reference: python/ctranslate2/models/__init__.py re-exports Whisper and
Wav2Vec2*)."""

_SPEECH_EXPORTS = {
    "Whisper", "WhisperGenerationResult", "WhisperAlignmentResult",
    "Wav2Vec2", "Wav2Vec2Bert",
}


def __getattr__(name):
    # Lazy: the runtime modules import models.loader, so a top-level import
    # here would be circular.
    if name in _SPEECH_EXPORTS:
        from ..runtime import wav2vec2, whisper

        return getattr(whisper, name, None) or getattr(wav2vec2, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
