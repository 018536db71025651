# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: cri.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tcri.proto\x12\nruntime.v1\"!\n\x0eVersionRequest\x12\x0f\n\x07version\x18\x01 \x01(\t\"n\n\x0fVersionResponse\x12\x0f\n\x07version\x18\x01 \x01(\t\x12\x14\n\x0cruntime_name\x18\x02 \x01(\t\x12\x17\n\x0fruntime_version\x18\x03 \x01(\t\x12\x1b\n\x13runtime_api_version\x18\x04 \x01(\t\"@\n\x13\x43ontainerStateValue\x12)\n\x05state\x18\x01 \x01(\x0e\x32\x1a.runtime.v1.ContainerState\"\xe3\x01\n\x0f\x43ontainerFilter\x12\n\n\x02id\x18\x01 \x01(\t\x12.\n\x05state\x18\x02 \x01(\x0b\x32\x1f.runtime.v1.ContainerStateValue\x12\x16\n\x0epod_sandbox_id\x18\x03 \x01(\t\x12\x46\n\x0elabel_selector\x18\x04 \x03(\x0b\x32..runtime.v1.ContainerFilter.LabelSelectorEntry\x1a\x34\n\x12LabelSelectorEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"D\n\x15ListContainersRequest\x12+\n\x06\x66ilter\x18\x01 \x01(\x0b\x32\x1b.runtime.v1.ContainerFilter\"2\n\x11\x43ontainerMetadata\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07\x61ttempt\x18\x02 \x01(\r\"\x8b\x01\n\tImageSpec\x12\r\n\x05image\x18\x01 \x01(\t\x12;\n\x0b\x61nnotations\x18\x02 \x03(\x0b\x32&.runtime.v1.ImageSpec.AnnotationsEntry\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xab\x03\n\tContainer\x12\n\n\x02id\x18\x01 \x01(\t\x12\x16\n\x0epod_sandbox_id\x18\x02 \x01(\t\x12/\n\x08metadata\x18\x03 \x01(\x0b\x32\x1d.runtime.v1.ContainerMetadata\x12$\n\x05image\x18\x04 \x01(\x0b\x32\x15.runtime.v1.ImageSpec\x12\x11\n\timage_ref\x18\x05 \x01(\t\x12)\n\x05state\x18\x06 \x01(\x0e\x32\x1a.runtime.v1.ContainerState\x12\x12\n\ncreated_at\x18\x07 \x01(\x03\x12\x31\n\x06labels\x18\x08 \x03(\x0b\x32!.runtime.v1.Container.LabelsEntry\x12;\n\x0b\x61nnotations\x18\t \x03(\x0b\x32&.runtime.v1.Container.AnnotationsEntry\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"C\n\x16ListContainersResponse\x12)\n\ncontainers\x18\x01 \x03(\x0b\x32\x15.runtime.v1.Container\"?\n\x16\x43ontainerStatusRequest\x12\x14\n\x0c\x63ontainer_id\x18\x01 \x01(\t\x12\x0f\n\x07verbose\x18\x02 \x01(\x08\"\x82\x04\n\x0f\x43ontainerStatus\x12\n\n\x02id\x18\x01 \x01(\t\x12/\n\x08metadata\x18\x02 \x01(\x0b\x32\x1d.runtime.v1.ContainerMetadata\x12)\n\x05state\x18\x03 \x01(\x0e\x32\x1a.runtime.v1.ContainerState\x12\x12\n\ncreated_at\x18\x04 \x01(\x03\x12\x12\n\nstarted_at\x18\x05 \x01(\x03\x12\x13\n\x0b\x66inished_at\x18\x06 \x01(\x03\x12\x11\n\texit_code\x18\x07 \x01(\x05\x12$\n\x05image\x18\x08 \x01(\x0b\x32\x15.runtime.v1.ImageSpec\x12\x11\n\timage_ref\x18\t \x01(\t\x12\x0e\n\x06reason\x18\n \x01(\t\x12\x0f\n\x07message\x18\x0b \x01(\t\x12\x37\n\x06labels\x18\x0c \x03(\x0b\x32\'.runtime.v1.ContainerStatus.LabelsEntry\x12\x41\n\x0b\x61nnotations\x18\r \x03(\x0b\x32,.runtime.v1.ContainerStatus.AnnotationsEntry\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xb0\x01\n\x17\x43ontainerStatusResponse\x12+\n\x06status\x18\x01 \x01(\x0b\x32\x1b.runtime.v1.ContainerStatus\x12;\n\x04info\x18\x02 \x03(\x0b\x32-.runtime.v1.ContainerStatusResponse.InfoEntry\x1a+\n\tInfoEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01*k\n\x0e\x43ontainerState\x12\x15\n\x11\x43ONTAINER_CREATED\x10\x00\x12\x15\n\x11\x43ONTAINER_RUNNING\x10\x01\x12\x14\n\x10\x43ONTAINER_EXITED\x10\x02\x12\x15\n\x11\x43ONTAINER_UNKNOWN\x10\x03\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'cri_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CONTAINERFILTER_LABELSELECTORENTRY._options = None
  _CONTAINERFILTER_LABELSELECTORENTRY._serialized_options = b'8\001'
  _IMAGESPEC_ANNOTATIONSENTRY._options = None
  _IMAGESPEC_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _CONTAINER_LABELSENTRY._options = None
  _CONTAINER_LABELSENTRY._serialized_options = b'8\001'
  _CONTAINER_ANNOTATIONSENTRY._options = None
  _CONTAINER_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _CONTAINERSTATUS_LABELSENTRY._options = None
  _CONTAINERSTATUS_LABELSENTRY._serialized_options = b'8\001'
  _CONTAINERSTATUS_ANNOTATIONSENTRY._options = None
  _CONTAINERSTATUS_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _CONTAINERSTATUSRESPONSE_INFOENTRY._options = None
  _CONTAINERSTATUSRESPONSE_INFOENTRY._serialized_options = b'8\001'
  _CONTAINERSTATE._serialized_start=1992
  _CONTAINERSTATE._serialized_end=2099
  _VERSIONREQUEST._serialized_start=25
  _VERSIONREQUEST._serialized_end=58
  _VERSIONRESPONSE._serialized_start=60
  _VERSIONRESPONSE._serialized_end=170
  _CONTAINERSTATEVALUE._serialized_start=172
  _CONTAINERSTATEVALUE._serialized_end=236
  _CONTAINERFILTER._serialized_start=239
  _CONTAINERFILTER._serialized_end=466
  _CONTAINERFILTER_LABELSELECTORENTRY._serialized_start=414
  _CONTAINERFILTER_LABELSELECTORENTRY._serialized_end=466
  _LISTCONTAINERSREQUEST._serialized_start=468
  _LISTCONTAINERSREQUEST._serialized_end=536
  _CONTAINERMETADATA._serialized_start=538
  _CONTAINERMETADATA._serialized_end=588
  _IMAGESPEC._serialized_start=591
  _IMAGESPEC._serialized_end=730
  _IMAGESPEC_ANNOTATIONSENTRY._serialized_start=680
  _IMAGESPEC_ANNOTATIONSENTRY._serialized_end=730
  _CONTAINER._serialized_start=733
  _CONTAINER._serialized_end=1160
  _CONTAINER_LABELSENTRY._serialized_start=1063
  _CONTAINER_LABELSENTRY._serialized_end=1108
  _CONTAINER_ANNOTATIONSENTRY._serialized_start=680
  _CONTAINER_ANNOTATIONSENTRY._serialized_end=730
  _LISTCONTAINERSRESPONSE._serialized_start=1162
  _LISTCONTAINERSRESPONSE._serialized_end=1229
  _CONTAINERSTATUSREQUEST._serialized_start=1231
  _CONTAINERSTATUSREQUEST._serialized_end=1294
  _CONTAINERSTATUS._serialized_start=1297
  _CONTAINERSTATUS._serialized_end=1811
  _CONTAINERSTATUS_LABELSENTRY._serialized_start=1063
  _CONTAINERSTATUS_LABELSENTRY._serialized_end=1108
  _CONTAINERSTATUS_ANNOTATIONSENTRY._serialized_start=680
  _CONTAINERSTATUS_ANNOTATIONSENTRY._serialized_end=730
  _CONTAINERSTATUSRESPONSE._serialized_start=1814
  _CONTAINERSTATUSRESPONSE._serialized_end=1990
  _CONTAINERSTATUSRESPONSE_INFOENTRY._serialized_start=1947
  _CONTAINERSTATUSRESPONSE_INFOENTRY._serialized_end=1990
# @@protoc_insertion_point(module_scope)
