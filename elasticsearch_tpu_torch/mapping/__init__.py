"""Document schema: field types and the MapperService (``mapping/types.py``,
``mapping/mapper.py``)."""

from elasticsearch_tpu_torch.mapping.mapper import (  # noqa: F401
    DocumentMapper, MapperService, ParsedDocument)
from elasticsearch_tpu_torch.mapping.types import (  # noqa: F401
    FieldType, KeywordFieldType, TextFieldType, field_type_for)
